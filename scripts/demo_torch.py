#!/usr/bin/env python
"""Demo entry point of the PyTorch/CUDA port (gdn_tpu_torch/demo.py), the
counterpart of scripts/demo.py: depth for a single image, a directory of
frames or a video, written as colorized maps (``<name>_depth.png``, the
frame above its depth unless ``--no_side_by_side``) and, with ``--gif``,
an animated GIF.

The G-net is the newest checkpoint in ``<model_dir>/stage2/`` that
scripts/train_torch.py wrote, with the architecture of its config.json
(``--use_ema``: its EMA weights).  Runs on the card (``--device cuda``,
the default) or, when asked, on the CPU.  Video input needs the
``imageio`` package.

Examples:
  python scripts/demo_torch.py --input img.png --model_dir checkpoints --output out/
  python scripts/demo_torch.py --input frames_dir/ --gif demo.gif --output out/
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
    p.add_argument("--input", type=str, required=True,
                   help="image file, directory of frames, or video file")
    p.add_argument("--output", type=str, default="demo_out")
    p.add_argument("--gif", type=str, default="",
                   help="also write an animated GIF with this name")
    p.add_argument("--cmap", type=str, default="magma")
    p.add_argument("--no_side_by_side", action="store_true")
    p.add_argument("--flip_tta", action="store_true",
                   help="horizontal-flip test-time averaging")
    p.add_argument("--use_ema", action="store_true",
                   help="use the EMA weights of an --ema_decay training run")
    return parse_or_exit(p, argv)


def main(argv=None):
    args = parse_args(argv)

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.cli import apply_saved_model_config, build_config
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.demo import run_demo

    device = resolve_device(args.device)
    cfg = build_config(args)
    stage_dir = os.path.join(cfg.train.ckpt_dir, "stage2")
    cfg = apply_saved_model_config(cfg, args, stage_dir)
    try:
        params = ckpt.load_params(stage_dir, key="ema" if args.use_ema else "params")
    except KeyError as e:
        raise SystemExit(f"demo_torch.py: --use_ema: {e.args[0]}") from None
    written = run_demo(cfg, params, args.input, args.output, gif=args.gif or None,
                       cmap=args.cmap, side_by_side=not args.no_side_by_side,
                       flip_tta=args.flip_tta, device=device)
    for path in written:
        print(path)
    return written


if __name__ == "__main__":
    main()
