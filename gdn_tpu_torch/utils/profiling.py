"""Spans and tracing of the port (port of ``gdn_tpu/utils/profiling.py``)
on ``torch.profiler``.

- ``span(name)``: a context manager around one pass through a layer
  boundary.  While a ``torch.profiler`` session records on this thread
  it enters ``torch.profiler.record_function(name)``, so the span sits
  in the Chrome trace as a ``user_annotation`` on the device rows'
  clock, and adds nothing here.  Otherwise it adds its duration (two
  ``time.perf_counter_ns`` reads) to the process's table: a count, a sum
  and a ring of the last ``RING`` durations a name.  The profiler slows
  the host, so durations taken under it are not kept beside the
  untraced ones.  ``ns`` holds the duration afterwards, traced or not.
- ``stats(name)``: ``count``, ``sum_ms`` and ``median_ms`` (of the ring);
  ``totals(name)``: (count, sum ns); ``reset()`` empties the table.  The
  table is safe to update from any thread.
- ``trace(logdir)``: a context manager that profiles the host and, when
  there is one, the card, and writes a Chrome trace (``trace_*.json``,
  for Perfetto or chrome://tracing) into ``logdir``; it yields the
  profile, whose ``trace_path`` names the file afterwards.

``kernel_times`` reads a profile's kernels, counting each kernel's own
device rows only: an operator's row repeats its kernels' time, and so
does a user annotation.  ``summarize``'s idle share is 1 minus the union
of the card's operation intervals (``device_intervals``) over the wall
time: kernels, copies and sets on other streams overlap, and a sum would
count them twice.
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

RING = 4096


class SpanTable:
    """Durations by name: [count, sum ns, ring of the last ``ring`` ns]."""

    def __init__(self, ring: int = RING):
        self._ring = ring
        self._lock = threading.Lock()
        self._rows: Dict[str, list] = {}

    def add(self, name: str, ns: int) -> None:
        with self._lock:
            row = self._rows.get(name)
            if row is None:
                row = self._rows[name] = [0, 0, collections.deque(maxlen=self._ring)]
            row[0] += 1
            row[1] += ns
            row[2].append(ns)

    def totals(self, name: str) -> Tuple[int, int]:
        with self._lock:
            row = self._rows.get(name)
            return (row[0], row[1]) if row else (0, 0)

    def stats(self, name: str) -> Dict[str, Optional[float]]:
        with self._lock:
            n, total, ring = self._rows.get(name) or (0, 0, ())
            durs = list(ring)
        return {"count": n, "sum_ms": total / 1e6,
                "median_ms": statistics.median(durs) / 1e6 if durs else None}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


TABLE = SpanTable()
totals, stats, reset = TABLE.totals, TABLE.stats, TABLE.reset


class span:
    """``with span(name):`` one pass through a layer boundary (see the
    module's docstring)."""

    __slots__ = ("name", "ns", "_t0", "_rf")

    def __init__(self, name: str):
        self.name, self.ns = name, 0

    def __enter__(self) -> "span":
        if torch._C._autograd._profiler_enabled():  # recording on this thread
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        else:
            TABLE.add(self.name, self.ns)


@contextlib.contextmanager
def trace(logdir: str, cuda: Optional[bool] = None) -> Iterator[object]:
    """Profile the body (the CPU, and the card when ``cuda``, default:
    when one is available) and write its Chrome trace into ``logdir``;
    yields the profile, whose ``trace_path`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    os.makedirs(logdir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    fd, prof.trace_path = tempfile.mkstemp(suffix=".json", prefix="trace_", dir=logdir)
    os.close(fd)
    prof.export_chrome_trace(prof.trace_path)


def kernel_times(prof, cpu: bool = False) -> Dict[str, Tuple[float, int]]:
    """{kernel name: (device us, calls)} of a profile's card rows; with
    ``cpu``, {operator: (self CPU us, calls)} of its host rows instead
    (a run on the CPU has no card rows)."""
    from torch.autograd import DeviceType

    if cpu:
        return {e.key: (e.self_cpu_time_total, e.count) for e in prof.key_averages()
                if e.self_cpu_time_total > 0 and not getattr(e, "is_user_annotation", False)}
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)}


def device_intervals(prof) -> List[Tuple[float, float]]:
    """(start us, end us) of every operation on the card (kernels, copies,
    sets) in a profile that :func:`trace` yielded."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_us(intervals) -> float:
    """Microseconds in which some interval runs: the length of their union."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def summarize(kernels: Dict[str, Tuple[float, int]], intervals, n_steps: int,
              wall_s: float, top: int = 12) -> Dict[str, object]:
    """Per-step device ms (the sum of :func:`kernel_times`), launches, the
    idle share of the wall-clock time (1 - the union of ``intervals``,
    :func:`device_intervals`, over the wall) and the ``top`` kernels by
    device time (ms a step, calls a step)."""
    kernel_us = sum(us for us, _ in kernels.values())
    calls = sum(n for _, n in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_ms_per_step": kernel_us / 1e3 / n_steps,
        "wall_ms_per_step": wall_s * 1e3 / n_steps,
        "launches_per_step": calls / n_steps,
        "idle_share": (1.0 - busy_us(intervals) / 1e6 / wall_s if wall_s > 0
                       else float("nan")),
        "top_kernels": [(name, us / 1e3 / n_steps, n / n_steps) for name, (us, n) in ranked],
    }
