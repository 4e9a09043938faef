"""Windowed SSIM on depth maps, plain PyTorch (port of
``gdn_tpu/ops/ssim.py``).

The Gaussian window is the JAX package's: a separable 11-tap, sigma 1.5
kernel with reflect-101 edges (``j < 0 -> -j``, ``j >= n -> 2n-2-j``),
written as a dense band matrix so that ``M @ x`` blurs along one axis.
This is the plain form: the fused loss kernel (``csrc/fused_loss.cu``)
computes the same blur as an 11-tap stencil in shared memory.

Precision: every blur runs in fp32.  The JAX package's ``precision``
knob selects MXU passes on a TPU; here it is checked and ignored (fp32
matmuls on the card are full fp32 unless TF32 is switched on).

Layout: (B, H, W) or (B, H, W, 1) float maps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PRECISIONS = ("default", "high", "highest")


def gaussian_kernel_1d(window: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalized 1-D Gaussian, matching the standard SSIM window."""
    half = (window - 1) / 2.0
    x = np.arange(window, dtype=np.float64) - half
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def blur_matrix(size: int, window: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(size, size) band matrix M with M @ x = gaussian-blur of x along
    axis 0, reflect-101 padding.  Not symmetric near the edges: a
    reflected tap adds to the column of its source pixel."""
    g = gaussian_kernel_1d(window, sigma).astype(np.float64)
    half = window // 2
    m = np.zeros((size, size), dtype=np.float64)
    for i in range(size):
        for t in range(window):
            j = i + t - half
            if j < 0:
                j = -j
            elif j >= size:
                j = 2 * size - 2 - j
            m[i, j] += g[t]
    return m.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _blur_matrix_cached(size: int, window: int, sigma: float) -> torch.Tensor:
    return torch.from_numpy(blur_matrix(size, window, sigma))


def blur_matrices(h: int, w: int, window: int, sigma: float, device):
    """(my, mx): the row and column band matrices of an (H, W) map."""
    return (_blur_matrix_cached(h, window, sigma).to(device),
            _blur_matrix_cached(w, window, sigma).to(device))


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown ssim precision {precision!r} {PRECISIONS}")


def blur(x: torch.Tensor, my: torch.Tensor, mx: torch.Tensor) -> torch.Tensor:
    """Separable blur of (B, H, W): rows by my @ x, columns by x @ mx^T."""
    return torch.matmul(torch.matmul(my, x), mx.T)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    max_val: float = 1.0,
    window: int = 11,
    sigma: float = 1.5,
    mean: bool = True,
    precision: str = "highest",
) -> torch.Tensor:
    """SSIM between depth maps in [0, max_val]: the scalar mean, or with
    ``mean=False`` the (B, H, W) map."""
    check_precision(precision)
    if pred.dim() == 4:
        pred, target = pred[..., 0], target[..., 0]
    pred = pred.float()
    target = target.float()
    h, w = pred.shape[-2], pred.shape[-1]
    my, mx = blur_matrices(h, w, window, sigma, pred.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu_x = blur(pred, my, mx)
    mu_y = blur(target, my, mx)
    mu_xx = blur(pred * pred, my, mx)
    mu_yy = blur(target * target, my, mx)
    mu_xy = blur(pred * target, my, mx)
    # clamp: non-negative in exact math, float cancellation can dip below
    sigma_x = torch.clamp(mu_xx - mu_x * mu_x, min=0.0)
    sigma_y = torch.clamp(mu_yy - mu_y * mu_y, min=0.0)
    sigma_xy = mu_xy - mu_x * mu_y

    num = (2.0 * mu_x * mu_y + c1) * (2.0 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    ssim_map = num / den
    return ssim_map.mean() if mean else ssim_map
