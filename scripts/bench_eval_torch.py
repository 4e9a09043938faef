#!/usr/bin/env python
"""Eval-throughput bench of the PyTorch/CUDA port, the counterpart of
scripts/bench_eval.py: images/s of ``evaluate.Evaluator`` through the
whole protocol (forward at train size, fp32 bilinear resize to the GT's
size, crop/cap/mask, the 8 per-image metrics) on a synthetic
KITTI-shaped split (a pool of 8 host images cycled; GT at KITTI's raw
375x1242), fed from the host (a prefetch thread, an upload a batch) or,
with ``--device_cache``, from the split staged on the card once.  The
G-net's weights are random (seed 0).  Prints one JSON line a pass.

Examples:
  python scripts/bench_eval_torch.py --device_cache
  python scripts/bench_eval_torch.py --eval_batch 64 --images 512
  python scripts/bench_eval_torch.py --device cpu --dtype float32 --images 4 \\
      --eval_batch 2 --gt_height 40 --gt_width 120 --height 32 --width 64
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from gdn_tpu_torch.config import add_fused_kernel_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--images", type=int, default=1024)
    p.add_argument("--eval_batch", type=int, default=256)
    p.add_argument("--gt_height", type=int, default=375)
    p.add_argument("--gt_width", type=int, default=1242)
    p.add_argument("--gt_wire", choices=["f32", "u16"], default="u16")
    p.add_argument("--device_cache", action="store_true")
    p.add_argument("--passes", type=int, default=2,
                   help="eval passes (the first includes the warm-up of the steps)")
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=416)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    add_fused_kernel_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from gdn_tpu_torch import checkpoint as ckpt
    from gdn_tpu_torch.config import fused_kernel_overrides, kitti_config, resolve_device
    from gdn_tpu_torch.evaluate import Evaluator
    from gdn_tpu_torch.models import RtoDNet
    from gdn_tpu_torch.train.loop import _prepare
    from gdn_tpu_torch.train.steps import make_eval_forward

    device = resolve_device(args.device)
    _prepare(device)
    gt_hw = (args.gt_height, args.gt_width)
    cfg = kitti_config(**{"model.image_size": (args.height, args.width),
                          "model.dtype": args.dtype, "model.use_pallas_gn": True,
                          "train.ckpt_dir": "", "eval.batch_size": args.eval_batch,
                          "eval.gt_wire": args.gt_wire, **fused_kernel_overrides(args)})
    h, w = cfg.model.image_size
    rng = np.random.default_rng(0)
    pool = [{"rgb": rng.random((1, h, w, 3), dtype=np.float32),
             "gt": rng.random((1, *gt_hw), dtype=np.float32) * (cfg.eval.cap - 1.0) + 1.0}
            for _ in range(8)]

    def dataset():
        for i in range(args.images):
            yield pool[i % len(pool)]

    net = RtoDNet(cfg.model)
    net.load_state_dict(ckpt.init_params(cfg.model, torch.Generator().manual_seed(0)))
    ev = Evaluator(cfg, make_eval_forward(cfg, net.to(device)), device=device)
    if args.device_cache:
        t0 = time.perf_counter()
        ev.cache_dataset(dataset())
        build_s = time.perf_counter() - t0
    lines = []
    for i in range(args.passes):
        out = ev.run(None if args.device_cache else dataset(), verbose=False)
        line = {"pass": i + 1, "fps": out["fps"], "batch": args.eval_batch,
                "images": args.images, "gt": list(gt_hw),
                "feeding": "device_cache" if args.device_cache else "host",
                "gt_wire": args.gt_wire,
                "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu")}
        if args.device_cache:
            line["cache_mb"] = ev.cached_bytes / 2**20
            line["cache_build_s"] = build_s
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
