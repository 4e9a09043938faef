#!/usr/bin/env python
"""Training-throughput bench of the PyTorch/CUDA port, the counterpart of
the root bench.py: images/s of the full stage-2 guided train step (the
frozen D-net's guidance forward, the G-net's forward and backward, the
Adam update) at B=32, 128x416, bf16, on synthetic batches drawn on the
card (no host input).

The host's clock moves between runs on the same code, so one number is
not enough: the bench times ``--calls`` windows (at least 3) of
``--iters`` steps each, after ``--warmup`` untimed steps, and reports
their median and spread ((max - min) / median).  Beside each window it
samples the card's SM clock (``nvidia-smi --query-gpu=clocks.sm``) and
the host's 1-minute load average.  Prints ONE JSON line: {"metric",
"value" (the median), "unit", "calls", "spread", ...} with the card's
name and power limit.  The JAX bench's estimated reference denominator
is not carried: it is a guess for another card.

Examples:
  python scripts/bench_torch.py
  python scripts/bench_torch.py --model.use_pallas_convgn_bt \\
      --model.use_pallas_convgn_s2 --model.use_pallas_fusion_bt
  python scripts/bench_torch.py --device cpu --dtype float32 --batch_size 2 \\
      --height 32 --width 64 --iters 1 --warmup 1      # CPU smoke run
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def smi(query: str):
    """``nvidia-smi --query-gpu=<query>`` of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def parse_args(argv=None):
    from gdn_tpu_torch.config import add_fused_kernel_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=416)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--iters", type=int, default=10, help="steps a timed window")
    p.add_argument("--calls", type=int, default=3, help="timed windows (at least 3)")
    add_fused_kernel_flags(p)
    args = p.parse_args(argv)
    if args.calls < 3:
        p.error("--calls must be at least 3: the bench reports a median and a spread")
    return args


def main(argv=None):
    args = parse_args(argv)

    import torch

    from gdn_tpu_torch.config import fused_kernel_overrides, kitti_config, resolve_device
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.train.loop import _prepare, stage1_state, stage2_state
    from gdn_tpu_torch.train.steps import make_stage2_step

    device = resolve_device(args.device)
    _prepare(device)  # the kernels build before the clock starts
    cfg = kitti_config(**{"model.image_size": (args.height, args.width),
                          "model.dtype": args.dtype, "model.use_pallas_gn": True,
                          "data.batch_size": args.batch_size, "train.ckpt_dir": "",
                          **fused_kernel_overrides(args)})
    d_net = stage1_state(cfg, device).net.requires_grad_(False)
    state = stage2_state(cfg, d_net.state_dict(), device)
    step = make_stage2_step(cfg)
    data = iter(SyntheticDataset(args.batch_size, args.height, args.width,
                                 cfg.model.max_depth, seed=0, device=device))
    batches = [next(data) for _ in range(4)]
    for i in range(args.warmup):
        state, terms = step(state, d_net, batches[i % 4])
    float(terms["total"])  # waits for the card
    rates, clocks, loads = [], [], []
    for _ in range(args.calls):
        clocks.append(smi("clocks.sm"))
        loads.append(os.getloadavg()[0])
        t0 = time.perf_counter()
        for i in range(args.iters):
            state, terms = step(state, d_net, batches[i % 4])
        float(terms["total"])
        rates.append(args.batch_size * args.iters / (time.perf_counter() - t0))
    med = statistics.median(rates)
    line = {
        "metric": "kitti_stage2_train_imgs_per_sec", "value": med, "unit": "imgs/sec",
        "calls": rates, "spread": (max(rates) - min(rates)) / med,
        "batch": args.batch_size, "image": [args.height, args.width], "dtype": args.dtype,
        "fused": sorted(fused_kernel_overrides(args)), "iters": args.iters,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "name_power_limit": smi("name,power.limit"), "sm_clock_mhz": clocks,
        "load_avg_1m": loads,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
