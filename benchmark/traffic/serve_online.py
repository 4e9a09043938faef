"""Online depth serving: an open loop of single-frame requests into the
port's ``server.DynamicBatcher`` (the HTTP front's batcher, behind the
decode and resize the front does), uint8 frames at the model's size in,
u16 depth out.

Arrivals follow ``harness.arrivals.mmpp2`` at the cell's ``rate`` (a
number found once by a sweep on the chip, ``benchmark/sweep_online.py``).
Sender threads take the requests in order, each waits for its due time,
calls ``predict`` and blocks for the answer; each request's latency runs
from its due time to its depth on the host, so a stall counts against
every request it delays.  How late the senders ran is printed.  A
request that fails or has no answer a minute past the window's close is
missing: it counts as slower than any answer and makes the run not
correct.

Parameters: ``batch``, ``max_wait_ms``, ``rate`` (mean requests a
second), ``burst_factor``, ``calm_stay_s``, ``burst_stay_s``,
``senders`` (threads), ``pool`` (frames), ``warm_s`` (seconds of the
same traffic in set-up), ``keep`` (answers kept for the check, drawn
from the seed), ``slice_s`` (seconds the traced slice profiles).
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import arrivals, inputs, serving
from harness.core import Run, percentile

GRACE_S = 60.0


def schedule(r: Run, seconds: float, tag: int) -> np.ndarray:
    p = r.params
    return arrivals.mmpp2(r.seed, p["rate"], seconds, p["burst_factor"], p["calm_stay_s"],
                          p["burst_stay_s"], tag)


def open_loop(batcher, pool: np.ndarray, due: np.ndarray, senders: int,
              keep: Optional[set] = None) -> Dict:
    """Send request i at ``t0 + due[i]``, frame ``i % len(pool)``; return
    the due, send and done times (done: inf for a missing answer) and the
    answers of the requests in ``keep``."""
    n = len(due)
    sent = np.full(n, math.nan)
    done = np.full(n, math.inf)
    answers: Dict[int, np.ndarray] = {}
    lock = threading.Lock()
    nxt = [0]
    go = threading.Event()
    clock = {}

    def sender():
        go.wait()
        t0, close = clock["t0"], clock["close"]
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= n:
                return
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent[i] = time.perf_counter()
            try:
                out = batcher.predict(pool[i % len(pool)],
                                      timeout=max(0.1, close + GRACE_S - sent[i]))
            except Exception:  # noqa: BLE001 - a failed request is counted missing
                continue
            done[i] = time.perf_counter()
            if keep is not None and i in keep:
                answers[i] = out

    threads = [threading.Thread(target=sender, daemon=True) for _ in range(senders)]
    for t in threads:
        t.start()
    # the clock starts once every sender is waiting, so none starts late
    t0 = clock["t0"] = time.perf_counter() + 0.01
    close = clock["close"] = t0 + (float(due[-1]) if n else 0.0)
    go.set()
    for t in threads:
        t.join(timeout=max(1.0, close + GRACE_S + 5.0 - time.perf_counter()))
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a sender thread outlived the grace period")
    return {"due": t0 + due, "sent": sent, "done": done, "answers": answers, "t0": t0}


def latencies_ms(rec: Dict) -> List[float]:
    return list((rec["done"] - rec["due"]) * 1e3)


def run(r: Run) -> None:
    from gdn_tpu_torch.server import DynamicBatcher

    p, cfgj, dev = r.params, r.cfgj, r.device
    h, w = cfgj["image_size"]
    g_p = serving.g_params(r)
    pool = inputs.frame_pool(r.seed, p["pool"], h, w, dev)
    batcher = DynamicBatcher(None, None, max_wait_ms=p["max_wait_ms"], wire="u16",
                             predictor=serving.predictor(r, g_p, p["batch"]))
    try:
        open_loop(batcher, pool, schedule(r, p["warm_s"], 1), p["senders"])
        due = schedule(r, r.seconds, 0)
        rng = np.random.default_rng(inputs.stream_seed(r.seed, 6))
        keep = set(int(i) for i in rng.choice(len(due), min(p["keep"], len(due)),
                                               replace=False))
        before = dict(batcher.stats)
        r.setup_done()

        rec = open_loop(batcher, pool, due, p["senders"], keep)
        stats = {k: batcher.stats[k] - before[k] for k in ("batches", "batched_items")}
        lat = latencies_ms(rec)
        missing = int(np.sum(~np.isfinite(rec["done"])))
        r.attempted, r.failed = len(due), missing
        r.sound = missing == 0
        r.e2e["serve_p95_ms"] = percentile(lat, 95)
        late = (rec["sent"] - rec["due"]) * 1e3
        r.note(f"window: {len(due)} requests ({len(due) / r.seconds:.1f}/s offered), "
               f"{missing} missing, {stats['batches']} batches; senders late by p50 "
               f"{np.nanpercentile(late, 50):.3f} ms, p99 {np.nanpercentile(late, 99):.3f} ms, "
               f"max {np.nanmax(late):.3f} ms")
        r.ctx.update(kind="online", batch=p["batch"], latencies_ms=lat, batcher=stats, cfg=cfgj)
        if r.trace:
            from harness.trace import profiled

            r.slice = profiled(lambda: open_loop(batcher, pool, schedule(r, p["slice_s"], 2),
                                                 p["senders"]))
    finally:
        batcher.stop()
    r.memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    answers = [(i % len(pool), a) for i, a in sorted(rec["answers"].items())]
    ref = serving.reference_depth(r, g_p, pool, [i for i, _ in answers])
    for name, v in serving.gaps(answers, ref).items():
        r.check(name, v, r.cell["limits"][name])
