#!/usr/bin/env python
"""HTTP depth-prediction server of the PyTorch/CUDA port
(gdn_tpu_torch/server.py), the counterpart of scripts/serve.py.

Serves the stage-2 G-net on the card (``--device cuda``, the default)
or, when asked, on the CPU.  Weights come from a ``.pth`` state_dict
written by scripts/export_torch.py, or are drawn at random from seed 0.

Examples:
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
    from gdn_tpu_torch.config import add_fused_kernel_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["kitti", "nyu"], default="kitti")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pth", type=str, help="state_dict .pth to serve")
    src.add_argument("--init_random", action="store_true",
                     help="serve random weights drawn from seed 0 (smoke "
                          "tests only)")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16", help="compute dtype of the conv stack")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500,
                   help="0 picks an ephemeral port (printed on start)")
    p.add_argument("--serve_batch", type=int, default=8,
                   help="pinned batch size the dynamic batcher fills")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="batching window opened by the first request")
    p.add_argument("--request_timeout", type=float, default=600.0,
                   help="per-request wait bound (seconds)")
    p.add_argument("--wire", choices=["f32", "u16"], default="f32",
                   help="device fetch format: f32 meters, or u16 "
                        "depth*256 counts (half the D2H bytes)")
    add_fused_kernel_flags(p)
    return p.parse_args(argv)


def build_config(args):
    from gdn_tpu_torch.config import fused_kernel_overrides, kitti_config, nyu_config

    preset = kitti_config if args.dataset == "kitti" else nyu_config
    return preset(**{"model.use_pallas_gn": True, "model.dtype": args.dtype,
                     **fused_kernel_overrides(args)})


def main():
    args = parse_args()

    import torch

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.server import DepthServer

    cfg = build_config(args)
    if args.init_random:
        sd = ckpt.init_params(cfg.model, torch.Generator().manual_seed(0))
    else:
        sd = ckpt.load_pth(args.pth)

    print("warming up the serving path...", flush=True)
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
