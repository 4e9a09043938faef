#!/usr/bin/env python
"""Export a stage-2 checkpoint of the PyTorch/CUDA port (gdn_tpu_torch)
as a deployable artifact, the counterpart of scripts/export.py: one
``torch.export`` program (``.pt2``) of the RGB -> depth forward with the
weights inside, pinned at (--export_batch, H, W, 3) float32.  Its graph
calls the hand-written kernels as the registered ops of
gdn_tpu_torch/kernels/ops.py; ``scripts/serve_torch.py --artifact``,
``gdn_tpu_torch.serving.load_model`` and
``BatchedPredictor.from_artifact`` run it with no model code and no
checkpoint.  (scripts/export_torch.py, another script, writes a JAX
checkpoint's weights as a ``.pth``.)

The weights are the newest checkpoint in ``<model_dir>/stage2/`` that
scripts/train_torch.py wrote (``--use_ema``: its EMA), with the
architecture of its config.json.  ``--device`` (cuda by default, or
cpu) stands for scripts/export.py's ``--platforms``: the artifact runs
on the device it is exported on.  ``--quantize int8`` bakes the int8
G-net in, its activation scales calibrated now on the images in
``--quant_calib_dir``, else on synthetic scenes; the scales are fixed
in the artifact, so calibrate on imagery like what it will serve.

Examples:
  python scripts/export_artifact_torch.py --ckpt_dir checkpoints \\
      --output model.pt2 --export_batch 8
  python scripts/export_artifact_torch.py --ckpt_dir checkpoints --use_ema \\
      --output model_int8.pt2 --quantize int8 --quant_calib_dir frames/
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from gdn_tpu_torch.cli import add_common_args, parse_or_exit

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--output", type=str, required=True, help="the .pt2 to write")
    p.add_argument("--export_batch", type=int, default=1,
                   help="the batch size the artifact is pinned at")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="bake int8 inference into the artifact (gdn_tpu_torch/ops/"
                        "quant.py), scales calibrated now on --quant_calib_dir images, "
                        "else on synthetic scenes")
    p.add_argument("--quant_calib_dir", type=str, default="",
                   help="directory of representative RGB images for int8 calibration")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA weights of an --ema_decay training run")
    return parse_or_exit(p, argv)


def main(argv=None):
    args = parse_args(argv)

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.cli import apply_saved_model_config, build_config
    from gdn_tpu_torch.serving import export_model

    stage_dir = os.path.join(args.model_dir, "stage2")
    cfg = apply_saved_model_config(build_config(args), args, stage_dir)
    try:
        sd = ckpt.load_params(stage_dir, key="ema" if args.use_ema else "params")
    except KeyError as e:
        raise SystemExit(f"export_artifact_torch.py: --use_ema: {e.args[0]}") from None
    scales = None
    if args.quantize != "none":
        from gdn_tpu_torch.ops.quant import quantized_model_and_scales

        _, scales = quantized_model_and_scales(
            cfg, sd, calib_dir=args.quant_calib_dir or None, device=args.device)
        print("int8: scales calibrated", flush=True)
    export_model(cfg, sd, args.output, batch_size=args.export_batch, device=args.device,
                 quant_scales=scales)
    print(f"exported {args.output} ({os.path.getsize(args.output) / 1e6:.1f} MB)",
          flush=True)


if __name__ == "__main__":
    main()
