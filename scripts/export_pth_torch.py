#!/usr/bin/env python
"""Export a checkpoint of the PyTorch/CUDA port (gdn_tpu_torch) as a
torch state_dict ``.pth``, the counterpart of scripts/export_torch.py
(which reads the JAX package's checkpoint) and the inverse of
scripts/import_pth_torch.py: models trained in the port travel back to
the original GDN-Pytorch's module names.

The weights are the newest checkpoint in ``<model_dir>/stage{N}/``
(``--use_ema``: its EMA), loaded strict into the stage's net, built on
``--device`` (cuda by default, or cpu) with the architecture of the
checkpoint's config.json.  ``--key_map`` renames the parameters, the
JAX package's JSON map of flax paths ("a/b/c") to torch keys; a
parameter it does not name keeps the port's key ("a.b.c").  Conv
kernels are OIHW; the tensors are float32.  (scripts/export_artifact_torch.py
writes a deployable program, not weights.)

Examples:
  python scripts/export_pth_torch.py --stage 2 --model_dir checkpoints \\
      --pth gdn_stage2.pth --key_map map.json
  python scripts/export_pth_torch.py --stage 2 --model_dir checkpoints \\
      --pth gdn_ema.pth --use_ema
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from gdn_tpu_torch.cli import add_common_args, parse_or_exit

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--pth", required=True, help="output .pth path")
    p.add_argument("--stage", choices=["1", "2"], default="2")
    p.add_argument("--key_map", default="",
                   help="JSON map of flax paths ('a/b/c') to torch keys")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA weights of an --ema_decay training run")
    return parse_or_exit(p, argv)


def main(argv=None):
    args = parse_args(argv)

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.cli import apply_saved_model_config, build_config
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.models import DtoDNet, RtoDNet

    device = resolve_device(args.device)
    stage_dir = os.path.join(args.model_dir, f"stage{args.stage}")
    cfg = apply_saved_model_config(build_config(args), args, stage_dir)
    try:
        sd = ckpt.load_params(stage_dir, key="ema" if args.use_ema else "params")
    except KeyError as e:
        raise SystemExit(f"export_pth_torch.py: --use_ema: {e.args[0]}") from None
    # the weights must be the configured net's, as the JAX script's template demands
    (DtoDNet if args.stage == "1" else RtoDNet)(cfg.model).to(device).load_state_dict(
        sd, strict=True)
    key_map = None
    if args.key_map:
        with open(args.key_map) as f:
            key_map = json.load(f)
    out = ckpt.params_to_torch(sd, key_map=key_map)
    ckpt.save_pth(out, args.pth)
    n = sum(v.numel() for v in out.values())
    print(f"wrote {args.pth}: {len(out)} tensors, {n / 1e6:.2f} M params "
          f"(stage {args.stage}{', EMA' if args.use_ema else ''})", flush=True)
    return out


if __name__ == "__main__":
    main()
