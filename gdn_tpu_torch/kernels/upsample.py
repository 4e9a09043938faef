"""Fused UpBlock up-conv: bilinear 2x upsample -> conv3x3 -> GroupNorm ->
ELU with the upsampled map never stored.

Replaces the TPU kernel ``gdn_tpu/kernels/upsample.py::fused_upsample_conv``.
The function: ``U`` = the exact-2x bilinear upsample of x (half-pixel
centers, edge clamp; rows ``2i = 0.25 x[i-1] + 0.75 x[i]``, ``2i+1 =
0.75 x[i] + 0.25 x[i+1]``, then the same along W; in fp32), rounded to
the tap dtype; SAME 3x3 convolution of U with the weights rounded to the
tap dtype, accumulated in fp32; per-(image, group) single-pass moments,
the variance clamped at 0; affine; ELU; float32 out whatever x's dtype.

On the card the kernels are those of ``kernels/conv_gn_elu.py``
(``csrc/conv_gn_elu.cu``) with the upsample in front, and U, four times
the size of x, never reaches device memory.  With bf16 taps the
tensor-core kernel ``conv3x3_stats_tc_up`` owns a 2-D tile of U, stages
the x patch it needs once a chunk of 32 channels, blends the tile and
its 1-pixel halo in shared memory once, and reads the nine taps from it
(weights from ``pack_weight_up``, tile from ``up_tile``); with fp32
taps the FMA kernel blends each im2col element from four pixels of x as
it gathers it.  The TPU kernel builds U in a VMEM scratch and gates on a
VMEM fit and on lane-padded widths; here any Cin, any Cout <= 1024
divisible by ``groups`` and any H < 2^14 and W < 2^15 (1 included) run
the kernel.  What stays is the semantic gate of the call site: the
function is the exact-2x one only.

Under grad the call runs inside ``FusedRecompute``: the inputs are kept
and the backward is the VJP of the fp32 reference
(``upsample_conv_reference``) on them, as the JAX package's.  Without
grad the call goes through the op ``gdn_tpu_torch::conv_gn_elu``
(``kernels/ops.py``).  A CPU tensor runs the plain version; a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from gdn_tpu_torch.kernels import ops
from gdn_tpu_torch.kernels.conv_gn_elu import (
    FusedRecompute, _check, _launch, conv_gn_elu_plain, needs_grad,
)
from gdn_tpu_torch.ops.resize import resize_bilinear, upsample2x_bilinear


def upsample_conv_plain(x, w, scale, bias, groups: int = 8, eps: float = 1e-6,
                        tap_dtype: str = "float32") -> torch.Tensor:
    """Plain version: upsample in fp32 (the kernel's shifted blends, so U
    is the kernel's bit for bit) -> round to the tap dtype -> conv in
    fp32 -> single-pass GroupNorm -> ELU; (B, Cout, 2H, 2W) float32.
    Differentiable by autograd in every tensor argument."""
    return conv_gn_elu_plain(upsample2x_bilinear(x.float()), w, scale, bias, groups,
                             eps, 1, tap_dtype, torch.float32)[0]


def upsample_conv_reference(x, w, scale, bias, groups: int = 8,
                            eps: float = 1e-6) -> torch.Tensor:
    """The fp32 reference whose VJP is the backward (as the JAX package's
    ``_reference``): ``resize_bilinear`` to 2x -> conv -> GroupNorm -> ELU,
    nothing rounded.  The same function as the plain version with fp32
    taps, through one interpolate call instead of the shifted blends."""
    h, wd = x.shape[2:]
    u = resize_bilinear(x.float(), (2 * h, 2 * wd))
    return conv_gn_elu_plain(u, w, scale, bias, groups, eps, 1, "float32",
                             torch.float32)[0]


def fused_upsample_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, groups: int = 8, eps: float = 1e-6,
                        tap_dtype: str = "float32") -> torch.Tensor:
    """Fused bilinear-2x upsample + conv3x3 (SAME) + GroupNorm + ELU.

    x (B, Cin, H, W) channels_last, fp32 or bf16; w (Cout, Cin, 3, 3);
    scale, bias (Cout,).  Returns (B, Cout, 2H, 2W) float32."""
    _check(x, None, w, None, scale, bias, groups, tap_dtype)

    def forward(x, w, scale, bias):
        if x.device.type == "cpu":
            return upsample_conv_plain(x, w, scale, bias, groups, eps, tap_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return _launch(fused_upsample_conv, x, None, w, None, scale, bias, groups, eps,
                       1, tap_dtype, torch.float32, False, upsample=True)[0]

    def reference(x, w, scale, bias):
        return upsample_conv_reference(x, w, scale, bias, groups, eps)

    if needs_grad(x, w, scale, bias):
        return FusedRecompute.apply(forward, reference, x, w, scale, bias)
    return ops.conv_gn_elu("fused_upsample_conv", x, None, w, None, scale, bias, groups,
                           eps, 1, True, tap_dtype, torch.float32)


fused_upsample_conv.launches = 0
