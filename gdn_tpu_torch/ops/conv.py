"""XLA "SAME" convolutions in PyTorch: the padding rule, the forward
and the input/weight gradients.

XLA pads total = max((ceil(n/s) - 1)*s + k - n, 0) with the extra
row/column at the bottom/right: asymmetric at stride 2 (e.g. (0, 1)
for n=128, k=3), which torch's symmetric ``padding=`` cannot say.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

CL = torch.channels_last


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) SAME padding of a length-n axis."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
              bias: Optional[torch.Tensor] = None, groups: int = 1) -> torch.Tensor:
    """XLA "SAME" convolution of NCHW x with an OIHW kernel; ``groups``
    is XLA's ``feature_group_count`` (kernel (Cout, Cin / groups, kh, kw))."""
    (t, b), (l, r) = (same_pads(x.shape[2], kernel.shape[2], stride),
                      same_pads(x.shape[3], kernel.shape[3], stride))
    kernel = kernel.contiguous(memory_format=CL)
    if t == b and l == r:
        return F.conv2d(x, kernel, bias, stride, padding=(t, l), groups=groups)
    return F.conv2d(F.pad(x, (l, r, t, b)), kernel, bias, stride, groups=groups)


def conv_same_backward(
    dy: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
    need_dx: bool = True, need_dkernel: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dkernel) of ``conv_same(x, kernel, stride)`` for the output
    cotangent dy: the standard input and weight gradient convolutions
    (cuDNN on the card), without running the forward again.  A gradient
    that is not needed is not computed and comes back as None."""
    (t, b), (l, r) = (same_pads(x.shape[2], kernel.shape[2], stride),
                      same_pads(x.shape[3], kernel.shape[3], stride))
    sym = t == b and l == r
    xin = x if sym else F.pad(x, (l, r, t, b))
    dx, dk, _ = torch.ops.aten.convolution_backward(
        dy, xin, kernel, None, (stride, stride), (t, l) if sym else (0, 0),
        (1, 1), False, (0, 0), 1, (need_dx, need_dkernel, False))
    if not sym and dx is not None:
        dx = dx[:, :, t:t + x.shape[2], l:l + x.shape[3]]
    return dx, dk
