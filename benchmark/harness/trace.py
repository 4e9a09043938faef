"""A profiled slice of a run, read from ``torch.profiler``'s Chrome trace.

``profiled(fn)`` runs ``fn`` under the profiler (host and card) inside a
span named ``bench.slice``, writes the trace to a temporary file, reads
it and deletes it.  The ``Slice`` it returns holds every device
operation (kernels, copies, sets) as an interval clipped to the span,
and the host operations, so that readers can take:

- busy time: the union of the device intervals (the input pipeline's
  and the predictor's copies run on other streams than the kernels, so
  a sum would count overlaps twice);
- kernel time and launches by name (the sum of their durations; the
  idle share is the union's business);
- the longest idle gaps, each named by the innermost host operation
  running at its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "bench.slice"


class Slice:
    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 host_ops: List[Tuple[str, float, float]], t0: float, t1: float):
        self.device_ops = device_ops  # (name, start us, end us), clipped
        self.host_ops = host_ops  # (name, start us, end us)
        self.t0, self.t1 = t0, t1
        self.read_s = 0.0  # seconds spent writing and reading the trace

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for s, e in sorted((s, e) for _, s, e in self.device_ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def kernels(self, pattern=None) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches the
        compiled regex ``pattern`` (every kernel when None)."""
        secs, n = 0.0, 0
        for name, s, e in self.device_ops:
            if name.startswith("Memcpy") or name.startswith("Memset"):
                continue
            if pattern is None or pattern.search(name):
                secs += (e - s) / 1e6
                n += 1
        return secs, n

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n[:160], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest stretches with no device operation, each named
        by the innermost host operation at its middle."""
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            inner = [(he - hs, name) for name, hs, he in self.host_ops
                     if hs <= mid <= he and name != SPAN]
            out.append([min(inner)[1][:160] if inner else "no host op", (e - s) / 1e6])
        return out


def _read(path: str) -> Tuple[list, list, float, float]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == SPAN and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the trace holds no {SPAN} span")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        end = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s, end = max(s, t0), min(end, t1)
            if end > s:
                dev.append((e.get("name", "?"), s, end))
        elif cat in ("cpu_op", "cuda_runtime", "user_annotation", "python_function"):
            host.append((e.get("name", "?"), s, end))
    return dev, host, t0, t1


def profiled(fn: Callable[[], object]) -> Slice:
    """Run ``fn`` under the profiler; the card is synchronized before and
    inside the span's end, so the span holds all of ``fn``'s work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            fn()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        t = time.perf_counter()
        prof.export_chrome_trace(path)
        dev, host, t0, t1 = _read(path)
    finally:
        os.unlink(path)
    sl = Slice(dev, host, t0, t1)
    sl.read_s = time.perf_counter() - t
    return sl
