#!/usr/bin/env python
"""Training entry point of the PyTorch/CUDA port (gdn_tpu_torch), the
counterpart of scripts/train.py.

``--mode DtoD`` trains the stage-1 depth autoencoder and writes
``<ckpt_dir>/stage1.pth``; ``--mode RtoD`` reads a stage-1 ``.pth``,
moves and freezes its decoder in a fresh G-net, trains stage 2 and
writes ``<ckpt_dir>/stage2.pth`` (loadable by scripts/serve_torch.py
--pth).  Runs on the card (``--device cuda``, the default) or, when
asked, on the CPU.  Only the synthetic data source is ported; the step
lines also go to ``<ckpt_dir>/train_log.jsonl``.

Examples:
  python scripts/train_torch.py --mode DtoD --dataset synthetic \\
      --epochs 1 --steps_per_epoch 50
  python scripts/train_torch.py --mode RtoD --dataset synthetic \\
      --epochs 1 --steps_per_epoch 50 --stage1_pth checkpoints/stage1.pth
  python scripts/train_torch.py --mode DtoD --dataset synthetic --device cpu \\
      --dtype float32 --height 32 --width 64 --batch_size 2 \\
      --epochs 1 --steps_per_epoch 3       # CPU smoke run
  python scripts/train_torch.py --mode DtoD --dataset synthetic \\
      --model.use_pallas_convgn_bt --model.use_pallas_convgn_s2 \\
      --model.use_pallas_fusion_bt --epochs 1 --steps_per_epoch 50
          # the 3x3 conv sites through the fused conv+GroupNorm+ELU kernels
  python scripts/train_torch.py --mode DtoD --dataset synthetic \\
      --model.use_pallas_fusion --epochs 1 --steps_per_epoch 50
          # the UpBlock up-convs through the upsample kernel and the
          # FusionBlocks through the per-image fusion kernel
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from gdn_tpu_torch.config import add_fused_kernel_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["DtoD", "RtoD"], default="DtoD",
                   help="DtoD = stage 1 (D-net), RtoD = stage 2 (G-net)")
    p.add_argument("--dataset", choices=["kitti", "nyu", "synthetic"],
                   default="kitti",
                   help="preset (image size, max depth); only synthetic "
                        "data is ported")
    p.add_argument("--height", type=int, default=None,
                   help="train height (default: the preset's)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16", help="compute dtype of the conv stack")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--ckpt_dir", type=str, default="checkpoints")
    p.add_argument("--stage1_pth", type=str, default="",
                   help="RtoD: the stage-1 .pth (default <ckpt_dir>/stage1.pth)")
    add_fused_kernel_flags(p)
    args = p.parse_args(argv)
    if args.dataset != "synthetic":
        p.error(f"--dataset {args.dataset}: the real-data loaders are not "
                "ported yet (ROADMAP.md Queue A item 8); use --dataset synthetic")
    return args


def build_config(args):
    from gdn_tpu_torch.config import fused_kernel_overrides, kitti_config

    over = {
        "model.use_pallas_gn": True, "model.dtype": args.dtype,
        "data.dataset": args.dataset, "data.batch_size": args.batch_size,
        "train.mode": args.mode, "train.epochs": args.epochs,
        "train.lr": args.lr, "train.seed": args.seed,
        "train.steps_per_epoch": args.steps_per_epoch,
        "train.log_every": args.log_every, "train.ckpt_dir": args.ckpt_dir,
        **fused_kernel_overrides(args),
    }
    if args.height or args.width:
        h0, w0 = kitti_config().model.image_size
        over["model.image_size"] = (args.height or h0, args.width or w0)
    return kitti_config(**over)


def main():
    args = parse_args()

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.train.loop import train_stage1, train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    cfg = build_config(args)
    h, w = cfg.model.image_size
    data = SyntheticDataset(args.batch_size, h, w, cfg.model.max_depth,
                            seed=args.seed, device=device)
    stage = "stage1" if args.mode == "DtoD" else "stage2"
    logger = MetricLogger(prefix=stage,
                          jsonl_path=os.path.join(args.ckpt_dir, "train_log.jsonl"))
    print(f"{stage}: {h}x{w}, batch {args.batch_size}, {args.dtype}, "
          f"device {device}", flush=True)
    if args.mode == "DtoD":
        train_stage1(cfg, data, logger=logger, device=device)
    else:
        d_params = ckpt.load_pth(args.stage1_pth
                                 or os.path.join(args.ckpt_dir, "stage1.pth"))
        train_stage2(cfg, data, d_params, logger=logger, device=device)
    logger.close()
    print(f"wrote {os.path.join(args.ckpt_dir, stage + '.pth')}", flush=True)


if __name__ == "__main__":
    main()
