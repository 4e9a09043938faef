#!/usr/bin/env python
"""Import reference-style torch ``.pth`` weights into a checkpoint of
the PyTorch/CUDA port (gdn_tpu_torch), the counterpart of
scripts/import_torch.py (which writes the JAX package's checkpoint):
the migration path for users of the original GDN-Pytorch, whose module
names differ from the port's.

The file may hold the state_dict itself or wrap it as
``{"state_dict": ...}``, and its keys may carry DataParallel's
``module.`` prefix.  ``--key_map`` is the JAX package's JSON map of
flax parameter paths to torch keys, ``{"encoder/stem/Conv_0/kernel":
"enc.conv1.weight", ...}``; a parameter it does not name is looked up
under the port's own key (``encoder.stem.Conv_0.kernel``).  Conv
kernels are OIHW in both.  ``--partial`` keeps the fresh weights of the
parameters the file lacks; without it a missing one stops the import,
naming the first five.

The weights go into a fresh TrainState of the stage (``--stage 1``: a
D-net; ``2``: a G-net with its own decoder) built from the flags, saved
as step 0 in ``<model_dir>/stage{N}/0.pt``.  No config.json is written:
the scripts that read the checkpoint (train_torch.py --resume or
--stage1_ckpt, eval_torch.py, serve_torch.py --ckpt_dir, demo_torch.py)
take the net from their flags, so give them the same architecture
flags.  Runs on the card (``--device cuda``, the default) or, when
asked, on the CPU.

Examples:
  python scripts/import_pth_torch.py --pth dtod.pth --stage 1 \\
      --model_dir checkpoints --key_map map.json
  python scripts/import_pth_torch.py --pth rtod.pth --stage 2 \\
      --model_dir checkpoints --key_map map.json --partial
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
    p.add_argument("--pth", required=True, help="torch state_dict file")
    p.add_argument("--stage", choices=["1", "2"], default="1")
    p.add_argument("--key_map", default="",
                   help="JSON map of flax paths ('a/b/c') to torch keys")
    p.add_argument("--partial", action="store_true",
                   help="allow missing keys (the fresh weights are kept)")
    return parse_or_exit(p, argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.cli import build_config
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.train.loop import stage1_state, stage2_state

    device = resolve_device(args.device)
    cfg = build_config(args)
    sd = ckpt.unwrap_state_dict(torch.load(args.pth, map_location="cpu", weights_only=True))
    key_map = None
    if args.key_map:
        with open(args.key_map) as f:
            key_map = json.load(f)
    state = stage1_state(cfg, device) if args.stage == "1" else stage2_state(cfg, None, device)
    try:
        params = ckpt.params_from_torch(state.net.state_dict(), sd, key_map=key_map,
                                        strict=not args.partial)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"import_pth_torch.py: {args.pth}: {e.args[0]}") from None
    state.net.load_state_dict(params, strict=True)
    out_dir = os.path.join(cfg.train.ckpt_dir, f"stage{args.stage}")
    ckpt.save_checkpoint(out_dir, 0, state)
    print(f"imported {len(sd)} torch tensors -> {out_dir} (step 0)", flush=True)
    return out_dir


if __name__ == "__main__":
    main()
