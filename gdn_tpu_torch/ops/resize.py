"""Resize ops with pinned interpolation semantics.

Port of ``gdn_tpu/ops/resize.py``.  Tensors are NCHW-shaped and conv
kernels OIHW (the port's layout); the JAX package's are NHWC and HWIO.

- bilinear: ``jax.image.resize(method="bilinear")``.  Where both axes
  grow or keep their size, that is half-pixel centers with edge clamp,
  ``F.interpolate(mode="bilinear", align_corners=False,
  antialias=False)`` (the model's route: it only upsamples).  Where an
  axis shrinks, JAX widens the triangle kernel by the scale
  (antialiasing, its default), as ``antialias=True`` does; on axes that
  grow the two agree to rounding, but ``antialias=False`` is the closer
  match there, so it is taken only when some axis shrinks (the eval
  protocol resizes predictions to whatever size the GT has).
- nearest: ``jax.image.resize(method="nearest")`` takes source pixel
  ``floor((i + 0.5) * in / out)``, which XLA compiles to a float32
  multiply by the constant ``in * (1 / out)`` (each step rounded to
  float32).  Torch's ``"nearest"`` floors ``i * in / out`` and its
  ``"nearest-exact"`` rounds the scale otherwise; either lands one
  pixel off where a center falls near a pixel edge (i = 155 of 311 from
  104), so the indices are computed here as XLA computes them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], precise: bool = True
) -> torch.Tensor:
    """Resize the (H, W) axes of (B, C, H, W).  ``precise=True`` computes
    in float32 whatever the input dtype; ``precise=False`` keeps it."""
    orig = x.dtype
    xc = x.float() if precise else x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    out = F.interpolate(xc, size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=shrinks)
    return out.to(orig)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the (H, W) axes of (B, C, H, W) with JAX's
    half-pixel centers, computed in float32 whatever the input dtype."""
    def index(n_in, n_out):
        scale = float(np.float32(n_in) * (np.float32(1) / np.float32(n_out)))
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * scale
        return torch.floor(pos).long().clamp_(max=n_in - 1)

    out = x.float().index_select(-2, index(x.shape[-2], size[0]))
    return out.index_select(-1, index(x.shape[-1], size[1])).to(x.dtype)


def compose_bilinear_deconv_kernel(k3: torch.Tensor) -> torch.Tensor:
    """Compose an OIHW 3x3 conv kernel with the exact-2x bilinear
    upsample into ONE (cout, cin, 6, 6) kernel: a stride-2 input-dilated
    correlation with it (see composed_resize_conv2x) equals
    ``conv3x3_SAME(resize_bilinear(x, 2x))`` on all interior pixels."""
    b = torch.tensor([0.25, 0.75, 0.75, 0.25], dtype=k3.dtype,
                     device=k3.device)
    b2 = b[:, None] * b[None, :]  # (4, 4) separable bilinear taps
    w = k3.new_zeros((*k3.shape[:2], 6, 6))
    for dy in range(3):
        for dx in range(3):
            w[:, :, dy:dy + 4, dx:dx + 4] += (
                b2[None, None] * k3[:, :, dy:dy + 1, dx:dx + 1]
            )
    return w


def _up_v(x: torch.Tensor) -> torch.Tensor:
    """Vertical exact-2x bilinear (half-pixel centers, edge clamp) of
    (B, C, H, W): rows 2i = 0.25*x[i-1] + 0.75*x[i], rows 2i+1 =
    0.75*x[i] + 0.25*x[i+1], clamped at the ends."""
    b, c, h, w = x.shape
    x_up = torch.cat([x[:, :, :1], x[:, :, :-1]], dim=2)
    x_dn = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
    r0 = 0.25 * x_up + 0.75 * x
    r1 = 0.75 * x + 0.25 * x_dn
    return torch.stack([r0, r1], dim=3).reshape(b, c, 2 * h, w)


def _up_h(x: torch.Tensor) -> torch.Tensor:
    """Horizontal counterpart of :func:`_up_v`."""
    b, c, h, w = x.shape
    x_lf = torch.cat([x[..., :1], x[..., :-1]], dim=3)
    x_rt = torch.cat([x[..., 1:], x[..., -1:]], dim=3)
    c0 = 0.25 * x_lf + 0.75 * x
    c1 = 0.75 * x + 0.25 * x_rt
    return torch.stack([c0, c1], dim=4).reshape(b, c, h, 2 * w)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Exact-2x bilinear upsample (half-pixel centers, edge clamp) of
    (B, C, H, W) by shifted blends, rows first and then columns: equal to
    ``resize_bilinear(x, (2H, 2W))`` up to the last bit's rounding, and
    the very arithmetic of the upsample kernel (kernels/upsample.py).
    H or W may be 1."""
    return _up_h(_up_v(x))


def composed_resize_conv2x(x: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """``conv3x3_SAME(resize_bilinear(x, 2x))`` without materializing the
    2x-resized tensor; exact everywhere, including the boundary.

    x: (B, Cin, H, W) with H, W >= 2; k3: (Cout, Cin, 3, 3).

    The bulk is ONE stride-2 transposed convolution with the composed
    6x6 kernel.  ``jax.lax.conv_transpose(..., "SAME")`` is an
    input-dilated correlation with the kernel unflipped and padding
    (3, 3); ``F.conv_transpose2d`` correlates with the kernel flipped
    and pads by k - 1 - padding, so the kernel goes in flipped with
    padding 2.  The composed kernel only matches on interior pixels
    (the resize's edge clamp vs the zero padding), so the outer 2
    output rows/cols are recomputed exactly on thin input slabs and
    stitched in.
    """
    b, cin, h, w = x.shape
    w6 = compose_bilinear_deconv_kernel(k3)  # (Cout, Cin, 6, 6)
    y = F.conv_transpose2d(
        x, w6.flip(2, 3).transpose(0, 1), stride=2, padding=2
    )

    def conv(u, pad_w):
        return F.conv2d(u, k3, padding=(0, pad_w))

    zrow = x.new_zeros((b, cin, 1, 2 * w))
    # top: output rows 0..1 need U rows 0..2 (from x rows 0..1) plus the
    # conv's zero row above; VALID vertically, SAME horizontally.
    ut = _up_h(_up_v(x[:, :, 0:2])[:, :, 0:3])
    top = conv(torch.cat([zrow, ut], dim=2), 1)
    # bottom: U rows 2h-3..2h-1 from x rows h-2..h-1; zero row below.
    ub = _up_h(_up_v(x[:, :, h - 2:])[:, :, 1:4])
    bot = conv(torch.cat([ub, zrow], dim=2), 1)
    if h == 2:  # no interior rows (torch refuses the empty VALID convs)
        return torch.cat([top, bot], dim=2)
    zcol = x.new_zeros((b, cin, 2 * h - 2, 1))
    # left: output rows 2..2h-3, cols 0..1 need U rows 1..2h-2 x cols
    # 0..2 (from x cols 0..1); zero col at the left, VALID both ways.
    ul = _up_h(_up_v(x[..., 0:2])[:, :, 1:2 * h - 1])[..., 0:3]
    left = conv(torch.cat([zcol, ul], dim=3), 0)
    # right: mirror.
    ur = _up_h(_up_v(x[..., w - 2:])[:, :, 1:2 * h - 1])[..., 1:4]
    right = conv(torch.cat([ur, zcol], dim=3), 0)

    mid = torch.cat([left, y[:, :, 2:-2, 2:-2], right], dim=3)
    return torch.cat([top, mid, bot], dim=2)
