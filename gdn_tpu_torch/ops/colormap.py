"""Depth colorization for the demo/inference surface (SURVEY.md §2.8).

Self-contained: a built-in magma-like LUT (sampled from matplotlib when
available, with a numpy fallback ramp) applied on normalized inverse
depth — near = bright, the convention of the reference's demo GIFs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_LUT_CACHE = {}


def _get_lut(name: str = "magma", n: int = 256) -> np.ndarray:
    key = (name, n)
    if key not in _LUT_CACHE:
        try:
            import matplotlib.cm as cm

            lut = cm.get_cmap(name)(np.linspace(0, 1, n))[:, :3]
        except Exception:
            # fallback: black -> purple -> orange -> yellow ramp
            t = np.linspace(0, 1, n)[:, None]
            lut = np.concatenate(
                [
                    np.clip(1.8 * t - 0.2, 0, 1),
                    np.clip(1.6 * t - 0.6, 0, 1) ** 1.2,
                    np.clip(np.sin(np.pi * t) * 0.7 + 0.3 * t, 0, 1) * (1 - t * 0.6),
                ],
                axis=1,
            )
        _LUT_CACHE[key] = lut.astype(np.float32)
    return _LUT_CACHE[key]


def colorize_depth(
    depth: np.ndarray,
    max_depth: Optional[float] = None,
    cmap: str = "magma",
    invert: bool = True,
) -> np.ndarray:
    """(H, W) depth in meters -> (H, W, 3) uint8 color image.

    `invert=True` colors by inverse depth (near = hot), matching the
    usual monodepth visualization.
    """
    d = np.asarray(depth, dtype=np.float32)
    if max_depth is None:
        max_depth = float(np.percentile(d[d > 0], 99)) if (d > 0).any() else 1.0
    # near plane for the inverse-depth normalization: 1/50 of the range
    # (1.6 m on KITTI's 80 m).  A hard-coded 1 m plane degenerated for
    # max_depth <= 1 (denominator clamped to 1e-6 -> solid-color image)
    # and saturated all content nearer than 1 m.
    near = max_depth / 50.0
    d = np.clip(d, near, max_depth)
    if invert:
        x = 1.0 / d
        x = (x - 1.0 / max_depth) / (1.0 / near - 1.0 / max_depth)
    else:
        x = d / max_depth
    x = np.clip(x, 0.0, 1.0)
    lut = _get_lut(cmap)
    idx = (x * (len(lut) - 1)).astype(np.int32)
    return (lut[idx] * 255).astype(np.uint8)
