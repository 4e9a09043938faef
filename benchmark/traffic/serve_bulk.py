"""Bulk depth inference: one closed-loop caller of the port's
``serving.BatchedPredictor.predict`` (which dispatches its batches two
ahead of the fetch), each call a chunk of uint8 frames from a pool made
at set-up from the seed and cycled, answered on the u16 wire.

Parameters (``params`` of the cell): ``batch`` (the predictor's),
``chunk`` (frames a call), ``pool`` (frames in the pool, a multiple of
``chunk``), ``keep_per_chunk`` and ``keep_max`` (answers kept for the
check: a reservoir of ``keep_max`` over ``keep_per_chunk`` a call, drawn
from the seed), ``warm_calls``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import inputs, serving
from harness.core import Run


def run(r: Run) -> None:
    p, cfgj, dev = r.params, r.cfgj, r.device
    h, w = cfgj["image_size"]
    g_p = serving.g_params(r)
    pool = inputs.frame_pool(r.seed, p["pool"], h, w, dev)
    pred = serving.predictor(r, g_p, p["batch"])
    chunk = p["chunk"]
    for _ in range(p["warm_calls"]):
        pred.predict(pool[:chunk], wire="u16")
    r.setup_done()

    rng = np.random.default_rng(inputs.stream_seed(r.seed, 4))
    kept, frames, calls, seen = [], 0, 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + r.seconds:
        start = (calls * chunk) % p["pool"]
        out = pred.predict(pool[start:start + chunk], wire="u16")
        calls += 1
        frames += out.shape[0]
        for j in rng.choice(chunk, p["keep_per_chunk"], replace=False):
            seen += 1  # a reservoir: every answer of the window alike likely kept
            slot = len(kept) if len(kept) < p["keep_max"] else int(rng.integers(seen))
            if slot < p["keep_max"]:
                item = (start + int(j), out[j].copy())
                kept[slot:slot + 1] = [item]
    elapsed = time.perf_counter() - t0
    r.attempted = calls * chunk
    r.failed = r.attempted - frames
    r.sound = r.failed == 0
    r.e2e["serve_imgs_per_s"] = frames / elapsed
    r.ctx.update(kind="bulk", batch=p["batch"], window_s=elapsed, window_units=frames,
                 cfg=cfgj)
    r.note(f"window: {calls} calls of {chunk} frames in {elapsed:.3f} s")

    if r.trace:
        from harness.trace import profiled

        r.slice = profiled(lambda: pred.predict(pool[:chunk], wire="u16"))
        r.ctx["slice_units"] = chunk  # frames, as window_units
    r.memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del pred
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = serving.reference_depth(r, g_p, pool, [i for i, _ in kept])
    for name, v in serving.gaps(kept, ref).items():
        r.check(name, v, r.cell["limits"][name])
    r.note(f"reference over {len(ref)} frames ({len(kept)} answers): "
           f"{time.perf_counter() - t:.2f} s")
