"""Fused FusionBlock, per-image form: concat(x, lateral) -> conv3x3 ->
GroupNorm -> ELU with the concatenated tensor never built, float32 out.

Replaces the TPU kernel
``gdn_tpu/kernels/fusion_block.py::fused_fusion_block``.  It is to
``fused_fusion_bt`` (``kernels/fusion_bt.py``) what ``fused_conv_gn_elu``
is to ``fused_conv_gn_elu_bt``: the same CUDA kernels
(``csrc/conv_gn_elu.cu``: the tensor-core K loop with bf16 taps, the FMA
one with fp32 taps, both over x and then the lateral, no concat built),
here with an fp32 store and no residuals, and a
backward that keeps the inputs and takes the VJP of the fp32 reference
on them (``FusedRecompute``) instead of the analytic one.  The TPU
kernel's lane and spatial padding and its VMEM gate have no counterpart:
every site runs the kernel, the (16+32) -> 16 one at 128x416 included.
A CPU tensor runs the plain version; a CUDA tensor launches the kernels
or raises.  Without grad the call goes through the op
``gdn_tpu_torch::conv_gn_elu`` (``kernels/ops.py``).
"""

from __future__ import annotations

import torch

from gdn_tpu_torch.kernels import ops
from gdn_tpu_torch.kernels.conv_gn_elu import (
    FusedRecompute, _check, conv_gn_elu_plain, forward_all, needs_grad,
)


def fusion_block_plain(x, lat, wx, wl, scale, bias, groups: int = 8, eps: float = 1e-6,
                       tap_dtype: str = "float32") -> torch.Tensor:
    """Plain version: the two convolutions through ``F.conv2d`` at the
    tap dtype, summed in fp32 (equal to the conv of the concat), GroupNorm,
    ELU; (B, Cout, H, W) float32.  Differentiable by autograd."""
    return conv_gn_elu_plain(x, wx, scale, bias, groups, eps, 1, tap_dtype,
                             torch.float32, lat.to(x.dtype), wl)[0]


def fused_fusion_block(x: torch.Tensor, lat: torch.Tensor, wx: torch.Tensor,
                       wl: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       groups: int = 8, eps: float = 1e-6,
                       tap_dtype: str = "float32") -> torch.Tensor:
    """Fused concat-conv3x3 (SAME) + GroupNorm + ELU.

    x (B, Cx, H, W), lat (B, Cl, H, W) channels_last, fp32 or bf16;
    wx (Cout, Cx, 3, 3) and wl (Cout, Cl, 3, 3), the halves of the concat
    conv's OIHW kernel; scale, bias (Cout,).  Returns (B, Cout, H, W)
    float32."""
    lat = lat.to(x.dtype)
    _check(x, lat, wx, wl, scale, bias, groups, tap_dtype)

    def forward(x, lat, wx, wl, scale, bias):
        return forward_all(fused_fusion_block, x, lat, wx, wl, scale, bias, groups, eps,
                           1, tap_dtype, torch.float32, False)[0]

    def reference(x, lat, wx, wl, scale, bias):
        return fusion_block_plain(x, lat, wx, wl, scale, bias, groups, eps, "float32")

    if needs_grad(x, lat, wx, wl, scale, bias):
        return FusedRecompute.apply(forward, reference, x, lat, wx, wl, scale, bias)
    return ops.conv_gn_elu("fused_fusion_block", x, lat, wx, wl, scale, bias, groups, eps,
                           1, False, tap_dtype, torch.float32)


fused_fusion_block.launches = 0
