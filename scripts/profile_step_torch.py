#!/usr/bin/env python
"""Profile training steps of the PyTorch/CUDA port and report where the
card's time goes, the counterpart of scripts/profile_step.py.

Runs one untimed step, then ``--steps`` steps of the chosen stage on
synthetic batches drawn on the card under ``utils.profiling.trace``
(torch.profiler; a Chrome trace is left in ``--logdir``), and prints one
JSON line (the device ms a step: the sum of the card's kernel times; the
wall ms a step; the kernel launches a step; the idle share, 1 - the
union of the card's operation intervals / wall) and the top kernels by
device time.  Each step is a ``step{i}`` span in the trace.
torch.profiler now and then returns a session with no card rows: the
steps then run again, up to 3 sessions.  On the CPU (``--device cpu``) the line holds the
operators' self CPU ms a step instead, and the table operators by self
CPU time.

Example:
  python scripts/profile_step_torch.py --mode RtoD --batch_size 32 --steps 3
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from gdn_tpu_torch.cli import add_common_args, parse_or_exit

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--mode", choices=["DtoD", "RtoD"], default="RtoD")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--logdir", type=str,
                   default=os.path.join(tempfile.gettempdir(), "gdn_torch_profile"))
    p.add_argument("--top", type=int, default=12)
    return parse_or_exit(p, argv)


def main(argv=None):
    args = parse_args(argv)

    import time

    from gdn_tpu_torch.cli import build_config
    from gdn_tpu_torch.config import _with, resolve_device
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.train.loop import _prepare, stage1_state, stage2_state
    from gdn_tpu_torch.train.steps import make_stage1_step, make_stage2_step
    from gdn_tpu_torch.utils.profiling import (
        device_intervals, kernel_times, span, summarize, trace,
    )

    device = resolve_device(args.device)
    _prepare(device)
    cfg = _with(build_config(args), **{"data.batch_size": args.batch_size,
                                        "train.ckpt_dir": ""})
    h, w = cfg.model.image_size
    batch = next(iter(SyntheticDataset(args.batch_size, h, w, cfg.model.max_depth, seed=0,
                                       device=device)))
    d_state = stage1_state(cfg, device)
    if args.mode == "DtoD":
        state, step = d_state, make_stage1_step(cfg)
        run = lambda s: step(s, batch)  # noqa: E731
    else:
        d_net = d_state.net.requires_grad_(False)
        state, step = stage2_state(cfg, d_net.state_dict(), device), make_stage2_step(cfg)
        run = lambda s: step(s, d_net, batch)  # noqa: E731
    state, terms = run(state)  # one-time costs (cuDNN's search, allocator growth) untraced
    float(terms["total"])
    cpu = device.type == "cpu"
    for attempt in range(1, 4):
        with trace(args.logdir, cuda=not cpu) as prof:
            t0 = time.perf_counter()
            for i in range(args.steps):
                with span(f"step{i}"):
                    state, terms = run(state)
            float(terms["total"])
            wall = time.perf_counter() - t0
        kernels = kernel_times(prof, cpu=cpu)
        if kernels:
            break
        print(f"(profiler session {attempt} recorded no device rows; again)", flush=True)
    out = summarize(kernels, device_intervals(prof), args.steps, wall, args.top)
    top = out.pop("top_kernels")
    if cpu:  # host operator times: no device metric to report
        out = {"cpu_self_ms_per_step": out["device_ms_per_step"],
               "wall_ms_per_step": out["wall_ms_per_step"],
               "ops_per_step": out["launches_per_step"]}
    else:
        out["imgs_per_sec_device"] = args.batch_size / out["device_ms_per_step"] * 1e3
    print(json.dumps({"mode": args.mode, "batch": args.batch_size, "steps": args.steps,
                      "device": str(device), **out}), flush=True)
    print(f"top {'operators (self CPU' if cpu else 'kernels (device'} ms/step, calls/step):")
    for name, ms, calls in top:
        print(f"  {name[:70]:70s} {ms:9.3f} {calls:7.1f}")
    print(f"trace left in {prof.trace_path}")
    return dict(out, top_kernels=top)


if __name__ == "__main__":
    main()
