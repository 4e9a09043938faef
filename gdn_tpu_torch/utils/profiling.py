"""Tracing and step timing (port of ``gdn_tpu/utils/profiling.py``) on
``torch.profiler``.

- ``trace(logdir)``: a context manager that profiles the host and, when
  there is one, the card, and writes a Chrome trace
  (``trace_*.json``, for Perfetto or chrome://tracing) into
  ``logdir``; it yields the profile (for :func:`kernel_times` and
  :func:`summarize`), whose ``trace_path`` names the file afterwards.
- ``annotate(name)``: a named span in the trace
  (``torch.profiler.record_function``).
- ``StepTimer``: host-clock step times with the first ``warmup`` steps
  left out, and their mean / p50 / p95.  ``stop(result)`` waits for the
  card first: for the stream of ``result``'s first tensor, else for the
  whole device.

``kernel_times`` reads a profile's kernels, counting each kernel's own
device rows only: an operator's row repeats its kernels' time, and so
does a user annotation.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


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


def annotate(name: str):
    """A named span visible in the trace."""
    return torch.profiler.record_function(name)


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


def summarize(kernels: Dict[str, Tuple[float, int]], n_steps: int, wall_s: float,
              top: int = 12) -> Dict[str, object]:
    """Per-step device ms, launches, the idle share of the wall-clock
    time (1 - device busy / wall) and the ``top`` kernels by device time
    (ms a step, calls a step) from :func:`kernel_times`."""
    busy_us = sum(us for us, _ in kernels.values())
    calls = sum(n for _, n in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_ms_per_step": busy_us / 1e3 / n_steps,
        "wall_ms_per_step": wall_s * 1e3 / n_steps,
        "launches_per_step": calls / n_steps,
        "idle_share": 1.0 - busy_us / 1e6 / wall_s if wall_s > 0 else float("nan"),
        "top_kernels": [(name, us / 1e3 / n_steps, n / n_steps) for name, (us, n) in ranked],
    }


def _first_tensor(result) -> Optional[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for r in result:
            t = _first_tensor(r)
            if t is not None:
                return t
    return None


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Stop the clock and return the step's seconds.  With a
        ``result``, the card's work on it is waited for first (its
        tensor's stream; the whole device when it holds none)."""
        if result is not None and torch.cuda.is_available():
            t = _first_tensor(result)
            if t is not None and t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
            else:
                torch.cuda.synchronize()
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }
