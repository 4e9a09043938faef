"""The program's own span samples, for the per-layer readers.

Since it has spans, the program keeps a table of each span's untraced
samples in memory (``gdn_tpu_torch.utils.profiling``): a span taken while
the profiler records goes to the trace instead, so the table holds the
set-up's and the window's samples and none of the slice's, which the
profiler slows.  A program without that table gives nothing here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple


def median_ms(name: str, least: int) -> Optional[float]:
    """The median ms of the program's untraced ``name`` samples; None
    where the program keeps no such table or counts fewer than
    ``least``."""
    try:
        from gdn_tpu_torch.utils import profiling
    except ImportError:
        return None
    stats = getattr(profiling, "stats", None)
    if stats is None:
        return None
    st = stats(name)
    if st["count"] < least or st["median_ms"] is None:
        return None
    return st["median_ms"]


def bulk_units(ctx: Dict) -> Tuple[int, int]:
    """(calls, batches) of a bulk cell's window: each call is a chunk of
    ``slice_units`` frames (the traced slice's one call) in batches of
    ``batch``."""
    chunk = ctx["slice_units"]
    calls = ctx["window_units"] // chunk
    return calls, calls * math.ceil(chunk / ctx["batch"])
