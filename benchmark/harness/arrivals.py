"""Open-loop arrival schedules, read from a cell's parameters.

``mmpp2``: a two-state modulated Poisson process.  A calm state and a
burst state at ``burst_factor`` times the calm rate alternate, with
exponential stays of mean ``calm_stay_s`` and ``burst_stay_s``; inside a
stay, arrivals are uniform (a Poisson process given its count).  So
that every seed offers the same work, the stays are the exponential
distribution's quantiles at evenly spaced levels, one pair a cycle,
shuffled by the seed, and scaled to fill ``seconds`` exactly; a stay's
count is its rate times its length, rounded.  The seed orders the stays
and places the arrivals: the number of requests, the set of stay
lengths and the mean rate are the same for every seed.
"""

from __future__ import annotations

import numpy as np

from harness.inputs import stream_seed


def mmpp2(seed: int, mean_rate: float, seconds: float, burst_factor: float = 2.0,
          calm_stay_s: float = 1.0, burst_stay_s: float = 0.25, tag: int = 0) -> np.ndarray:
    """Sorted due times in [0, seconds) of a schedule at ``mean_rate``
    requests a second on average."""
    cycle = calm_stay_s + burst_stay_s
    n = max(1, int(round(seconds / cycle)))
    levels = -np.log(1.0 - (np.arange(n) + 0.5) / n)  # exponential quantiles, mean ~1
    rng = np.random.default_rng(stream_seed(seed, 5, tag))
    calm = rng.permutation(levels) * calm_stay_s
    burst = rng.permutation(levels) * burst_stay_s
    scale = seconds / (calm.sum() + burst.sum())
    calm_rate = mean_rate * cycle / (calm_stay_s + burst_factor * burst_stay_s)
    burst_first = bool(rng.integers(2))
    times, t = [], 0.0
    for k in range(n):
        stays = [(calm[k], calm_rate), (burst[k], calm_rate * burst_factor)]
        for length, rate in (stays[::-1] if burst_first else stays):
            length *= scale
            count = int(round(rate * length))
            times.append(t + np.sort(rng.uniform(0.0, length, count)))
            t += length
    out = np.concatenate(times)
    return out[out < seconds]
