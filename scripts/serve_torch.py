#!/usr/bin/env python
"""HTTP depth-prediction server of the PyTorch/CUDA port
(gdn_tpu_torch/server.py), the counterpart of scripts/serve.py.

Serves the stage-2 G-net on the card (``--device cuda``, the default)
or, when asked, on the CPU.  Weights come from the newest checkpoint in
``<model_dir>/stage2/`` that scripts/train_torch.py wrote, with the
architecture of its config.json (``--use_ema``: its EMA weights), from a
``.pth`` state_dict written by scripts/export_torch.py (the flags
describe the model), or are drawn at random from seed 0.  The flags are
the JAX serve CLI's (gdn_tpu_torch/cli.py; ``--ckpt_dir`` is another
name of ``--model_dir``, default ``checkpoints``); ``--quantize int8``
and ``--artifact`` end the run at parse time, naming their ROADMAP item.

Examples:
  python scripts/serve_torch.py --ckpt_dir checkpoints --use_ema --port 8500
  python scripts/serve_torch.py --pth gdn_stage2.pth --port 8500
  python scripts/serve_torch.py --init_random --port 0
  python scripts/serve_torch.py --init_random --model.use_pallas_convgn_bt \
      --model.use_pallas_convgn_s2 --model.use_pallas_fusion_bt
          # the 3x3 conv sites through the fused conv+GroupNorm+ELU kernels
  python scripts/serve_torch.py --init_random --model.use_pallas_fusion
          # the UpBlock up-convs through the upsample kernel and the
          # FusionBlocks through the per-image fusion kernel

  curl -s -X POST --data-binary @img.png \
      "http://127.0.0.1:8500/predict?format=color" > depth.png
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
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500,
                   help="0 picks an ephemeral port (printed on start)")
    p.add_argument("--serve_batch", type=int, default=8,
                   help="pinned batch size the dynamic batcher fills")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="batching window opened by the first request")
    p.add_argument("--request_timeout", type=float, default=600.0,
                   help="per-request wait bound (seconds)")
    p.add_argument("--use_ema", action="store_true",
                   help="serve the EMA weights of an --ema_decay run (--ckpt_dir)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--init_random", action="store_true",
                     help="serve random weights drawn from seed 0 (smoke tests only)")
    src.add_argument("--pth", type=str, default="",
                     help="serve this state_dict .pth, described by the flags")
    p.add_argument("--wire", choices=["f32", "u16"], default="f32",
                   help="device fetch format: f32 meters, or u16 "
                        "depth*256 counts (half the D2H bytes)")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="post-training int8 serving (not ported)")
    p.add_argument("--quant_calib_dir", type=str, default="",
                   help="images to calibrate --quantize int8 on (not ported)")
    p.add_argument("--artifact", type=str, default="",
                   help="serve an exported artifact (not ported)")
    args = parse_or_exit(p, argv)
    if args.use_ema and (args.init_random or args.pth):
        p.error("--use_ema reads the EMA of a checkpoint: give --ckpt_dir")
    return args


def build_config(args):
    from gdn_tpu_torch.cli import build_config

    return build_config(args)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.cli import apply_saved_model_config
    from gdn_tpu_torch.server import DepthServer

    cfg = build_config(args)
    if args.init_random:
        sd = ckpt.init_params(cfg.model, torch.Generator().manual_seed(0))
    elif args.pth:
        sd = ckpt.load_pth(args.pth)
    else:
        stage_dir = os.path.join(args.model_dir, "stage2")
        cfg = apply_saved_model_config(cfg, args, stage_dir)
        try:
            sd = ckpt.load_params(stage_dir, key="ema" if args.use_ema else "params")
        except KeyError as e:
            raise SystemExit(f"serve_torch.py: --use_ema: {e.args[0]}") from None

    h, w = cfg.model.image_size
    print(f"warming up the serving path ({h}x{w})...", flush=True)
    server = DepthServer(
        cfg, sd, host=args.host, port=args.port,
        batch_size=args.serve_batch, max_wait_ms=args.max_wait_ms,
        timeout_s=args.request_timeout, wire=args.wire, device=args.device,
    )
    print(f"serving on http://{args.host}:{server.port} "
          f"(batch={args.serve_batch}, window={args.max_wait_ms}ms, "
          f"device={args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
