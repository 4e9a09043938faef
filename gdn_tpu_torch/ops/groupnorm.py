"""GroupNorm (+ fused activation), plain PyTorch.

Port of ``gdn_tpu/ops/groupnorm.py``.  Tensors are NCHW-shaped (any
memory format); statistics accumulate in float32 and the
full-resolution elementwise math stays in the input dtype, as in the
JAX package.

``group_norm_elu_plain`` is the plain version of the hand-written
GroupNorm+ELU kernel (``kernels/groupnorm.py``): the forward of
``group_norm_elu_analytic`` — single-pass moments in fp32 clamped at 0,
mean and inverse cast to the compute dtype, elementwise math in the
compute dtype.  The card's smoke check holds the kernel against it.

``group_norm_elu_analytic`` is the same forward with the JAX package's
hand-written two-reduce backward (``gn_elu_backward``); the CPU path of
every GN site runs it, and the kernel's autograd Function reuses its
backward.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def pick_groups(features: int, preferred: int) -> int:
    """Largest divisor of ``features`` that is <= preferred (>=1) — the
    shared group-count rule for every GN site."""
    g = max(1, min(preferred, features))
    while features % g:
        g -= 1
    return g


def _group_matrix(c: int, groups: int) -> np.ndarray:
    """(C, G) one-hot channel->group matrix (fp32)."""
    return np.kron(np.eye(groups), np.ones((c // groups, 1))).astype(
        np.float32
    )


def _chanreduce_stats(y: torch.Tensor, groups: int, eps: float):
    """Per-(image, channel) fp32 mean and inverse std of y's groups:
    single-pass E[y^2] - mean^2 over one contiguous HW reduce, clamped
    at 0 (cancellation can dip negative and rsqrt would give NaN)."""
    b, c = y.shape[0], y.shape[1]
    cg = c // groups
    yf = y.float()
    s1 = yf.sum(dim=(2, 3))  # (B, C)
    s2 = yf.square().sum(dim=(2, 3))
    n = y.shape[2] * y.shape[3] * cg
    mean_g = s1.view(b, groups, cg).sum(-1) / n  # (B, G)
    ex2_g = s2.view(b, groups, cg).sum(-1) / n
    var_g = torch.clamp(ex2_g - mean_g.square(), min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cg, dim=1)  # (B, C)
    inv_c = inv_g.repeat_interleave(cg, dim=1)
    return mean_c, inv_c


def group_norm_act(
    y: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    impl: str = "grouped",
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over (B, C, H, W) + optional activation.

    ``impl="chanreduce"``: single-pass moments (see _chanreduce_stats).
    ``impl="grouped"``: two-pass variance E[(y-mean)^2] per group, the
    flax GroupNorm formulation.
    """
    b, c, h, w = y.shape
    dt = y.dtype
    if impl == "chanreduce":
        mean_c, inv_c = _chanreduce_stats(y, groups, eps)
        yn = (y - mean_c.to(dt)[:, :, None, None]) * inv_c.to(dt)[:, :, None, None]
    elif impl == "grouped":
        yg = y.reshape(b, groups, c // groups, h, w)
        ygf = yg.float()
        mean = ygf.mean(dim=(2, 3, 4), keepdim=True)
        var = (ygf - mean).square().mean(dim=(2, 3, 4), keepdim=True)
        inv = torch.rsqrt(var + eps)
        yn = ((yg - mean.to(dt)) * inv.to(dt)).reshape(b, c, h, w)
    else:
        raise ValueError(f"unknown gn_impl {impl!r}")
    yn = yn * scale.to(dt)[:, None, None] + bias.to(dt)[:, None, None]
    return activation(yn) if activation is not None else yn


def group_norm_elu_plain(
    y: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain GroupNorm + ELU: the forward of the JAX package's
    ``group_norm_elu_analytic`` (equal to ``group_norm_act(...,
    activation=elu, impl="chanreduce")``)."""
    return group_norm_act(y, scale, bias, groups, F.elu, "chanreduce", eps)


def gn_elu_backward(da: torch.Tensor, yn: torch.Tensor, inv_c: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, groups: int):
    """Analytic backward of GroupNorm + ELU (port of the JAX package's
    ``_gn_elu_bwd``): from the normalized input yn (compute dtype) and
    the fp32 (B, C) inverse std, two full-tensor reduces give dy, dscale
    and dbias.  Elementwise math in the compute dtype, sums in fp32.
    Differs from autograd only where the variance clamp is active."""
    b, c, h, w = yn.shape
    cg = c // groups
    dt = yn.dtype
    sc = scale.to(dt)[:, None, None]
    z = yn * sc + bias.to(dt)[:, None, None]
    # ELU'(z) = 1 for z > 0 else exp(z); exp(min(z, 0)) cannot overflow
    dz = torch.where(z > 0, da, da * torch.exp(torch.clamp(z, max=0)))
    s_dz = dz.sum(dim=(2, 3), dtype=torch.float32)  # (B, C)
    s_dzyn = (dz * yn).sum(dim=(2, 3), dtype=torch.float32)
    n = h * w * cg
    scale32 = scale.float()

    def group_mean(s):  # (B, C) -> mean over each group, per channel
        return (s * scale32).view(b, groups, cg).sum(-1).div(n).repeat_interleave(cg, 1)

    m1 = group_mean(s_dz).to(dt)[:, :, None, None]
    m2 = group_mean(s_dzyn).to(dt)[:, :, None, None]
    dy = (dz * sc - m1 - yn * m2) * inv_c.to(dt)[:, :, None, None]
    return dy, s_dzyn.sum(0), s_dz.sum(0)


class _GroupNormELUAnalytic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, bias, groups, eps):
        mean_c, inv_c = _chanreduce_stats(y, groups, eps)
        dt = y.dtype
        yn = (y - mean_c.to(dt)[:, :, None, None]) * inv_c.to(dt)[:, :, None, None]
        z = yn * scale.to(dt)[:, None, None] + bias.to(dt)[:, None, None]
        ctx.save_for_backward(yn, inv_c, scale, bias)
        ctx.groups = groups
        return F.elu(z)

    @staticmethod
    def backward(ctx, da):
        yn, inv_c, scale, bias = ctx.saved_tensors
        dy, dscale, dbias = gn_elu_backward(da, yn, inv_c, scale, bias, ctx.groups)
        return dy, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def group_norm_elu_analytic(
    y: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm + ELU with the analytic backward (port of the JAX
    package's ``group_norm_elu_analytic``): forward value-identical to
    ``group_norm_elu_plain``; the backward keeps only yn and the (B, C)
    inverse std."""
    return _GroupNormELUAnalytic.apply(y, scale, bias, groups, eps)
