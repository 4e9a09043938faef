#!/usr/bin/env python3
"""Find the highest rate an online cell sustains: run its open loop at
each rate in turn, in one process, and print a JSON line a rate.

    python3 benchmark/sweep_online.py --workload nyu-serve-online --seed 1 \
        --seconds 8 --rates 800 1000 1200 1400

A rate is sustained when the backlog does not grow: the median latency
of the last tenth of the requests stays within twice the first tenth's,
and every request is answered.  The cell then offers about 0.8 times the
highest sustained rate, written into its file as a number.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import core, inputs, serving  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep measures on the card; none found", file=sys.stderr)
        return 2
    from gdn_tpu_torch.server import DynamicBatcher

    cell = core.load_cell(args.workload)
    drv = core.load_module("traffic", cell["kind"])
    r = core.Run(cell, core.load_config(cell["config"]), args.seed, args.seconds, False,
                 torch.device("cuda", 0))
    p = r.params
    h, w = r.cfgj["image_size"]
    pool = inputs.frame_pool(r.seed, p["pool"], h, w, r.device)
    batcher = DynamicBatcher(None, None, max_wait_ms=p["max_wait_ms"], wire="u16",
                             predictor=serving.predictor(r, serving.g_params(r), p["batch"]))
    try:
        drv.open_loop(batcher, pool, drv.schedule(r, p["warm_s"], 1), p["senders"])
        for rate in args.rates:
            r.params = {**p, "rate": rate}
            before = dict(batcher.stats)
            rec = drv.open_loop(batcher, pool, drv.schedule(r, args.seconds, 0), p["senders"])
            lat = np.asarray(drv.latencies_ms(rec))
            tenth = max(1, len(lat) // 10)
            first, last = np.median(lat[:tenth]), np.median(lat[-tenth:])
            items = batcher.stats["batched_items"] - before["batched_items"]
            batches = batcher.stats["batches"] - before["batches"]
            missing = int(np.sum(~np.isfinite(lat)))
            print(json.dumps({
                "rate": rate, "requests": len(lat), "missing": missing,
                "p50_ms": core.percentile(list(lat), 50), "p95_ms": core.percentile(list(lat), 95),
                "first_tenth_p50_ms": first, "last_tenth_p50_ms": last,
                "fill": items / max(1, batches * p["batch"]),
                "late_p99_ms": float(np.nanpercentile((rec["sent"] - rec["due"]) * 1e3, 99)),
                "sustained": bool(missing == 0 and last <= 2 * first)}), flush=True)
    finally:
        batcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
