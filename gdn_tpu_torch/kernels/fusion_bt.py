"""Fused FusionBlock: concat(x, lateral) -> conv3x3 -> GroupNorm -> ELU
with the concatenated tensor never built.

Replaces the TPU kernel ``gdn_tpu/kernels/fusion_bt.py::fused_fusion_bt``.
The CUDA kernels are those of ``kernels/conv_gn_elu.py``
(``csrc/conv_gn_elu.cu``): with bf16 taps the tensor-core K loop, whose
K columns a tap are x's channels and then the lateral's, gathered from
the two tensors against one bf16 pack of ``wx`` and ``wl``; with fp32
taps the FMA K loop, which walks x's channels through ``wx`` and then
the lateral's through ``wl``.  Either way the (Cx+Cl)-channel
activation never exists in device memory.  No gate on channel
counts or sizes: the (16+32) -> 16 site at 128x416, which the TPU
kernel's VMEM gate refuses, runs the kernel too.

Under grad the forward keeps ``(x, lat, wx, wl, scale, a, yn, inv)``
and the backward is the JAX package's ``_fb_bwd``: ELU' from the output,
the two-reduce GroupNorm backward, then input and weight gradients of
the two convolutions separately (cuDNN; XLA's on the TPU).  A CPU
tensor runs the plain version; a CUDA tensor launches the kernels or
raises.  Without grad the call goes through the op
``gdn_tpu_torch::conv_gn_elu`` (``kernels/ops.py``).
"""

from __future__ import annotations

import torch

from gdn_tpu_torch.kernels import ops
from gdn_tpu_torch.kernels.conv_gn_elu import (
    FusedConvGNELUAnalytic, Residuals, _check, conv_gn_elu_plain, forward_all,
    needs_grad,
)


def fusion_bt_plain(x, lat, wx, wl, scale, bias, groups: int = 8, eps: float = 1e-6,
                    tap_dtype: str = "bfloat16") -> Residuals:
    """Plain version -> (a, yn, inv): the two convolutions through
    ``F.conv2d``, summed in fp32 (equal to the conv of the concat)."""
    return conv_gn_elu_plain(x, wx, scale, bias, groups, eps, 1, tap_dtype, None,
                             lat.to(x.dtype), wl)


def fused_fusion_bt(x: torch.Tensor, lat: torch.Tensor, wx: torch.Tensor,
                    wl: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 8, eps: float = 1e-6,
                    tap_dtype: str = "bfloat16") -> torch.Tensor:
    """Fused concat-conv3x3 (SAME) + GroupNorm + ELU.

    x (B, Cx, H, W), lat (B, Cl, H, W) channels_last; wx (Cout, Cx, 3, 3)
    and wl (Cout, Cl, 3, 3), the halves of the concat conv's OIHW kernel;
    scale, bias (Cout,).  Returns (B, Cout, H, W) in x's dtype."""
    lat = lat.to(x.dtype)
    _check(x, lat, wx, wl, scale, bias, groups, tap_dtype)
    if needs_grad(x, lat, wx, wl, scale, bias):
        return FusedConvGNELUAnalytic.apply(fused_fusion_bt, x, lat, wx, wl, scale, bias,
                                            groups, eps, 1, tap_dtype)
    return ops.conv_gn_elu("fused_fusion_bt", x, lat, wx, wl, scale, bias, groups, eps,
                           1, False, tap_dtype, x.dtype)


def _fusion_bt_all(x, lat, wx, wl, scale, bias, groups=8, eps=1e-6,
                   tap_dtype="bfloat16") -> Residuals:
    """``fused_fusion_bt``'s forward with its residuals (a, yn, inv)."""
    lat = lat.to(x.dtype)
    _check(x, lat, wx, wl, scale, bias, groups, tap_dtype)
    return forward_all(fused_fusion_bt, x, lat, wx, wl, scale, bias, groups, eps, 1,
                       tap_dtype, x.dtype, True)


fused_fusion_bt.launches = 0
