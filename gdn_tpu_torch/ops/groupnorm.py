"""GroupNorm (+ fused activation), plain PyTorch.

Port of ``gdn_tpu/ops/groupnorm.py``.  Tensors are NCHW-shaped (any
memory format); statistics accumulate in float32 and the
full-resolution elementwise math stays in the input dtype, as in the
JAX package.

``group_norm_elu_plain`` is the plain version of the hand-written
GroupNorm+ELU kernel (``kernels/groupnorm.py``): the forward of
``group_norm_elu_analytic`` — single-pass moments in fp32 clamped at 0,
mean and inverse cast to the compute dtype, elementwise math in the
compute dtype.  The CPU path of every GN site runs it, and the card's
smoke check holds the kernel against it.
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
