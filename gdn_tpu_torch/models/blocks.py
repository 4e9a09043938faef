"""Building blocks of the D-net / G-net encoder-decoders.

Port of ``gdn_tpu/models/blocks.py`` for the configuration the port
runs (group norm, ELU, resize_conv upsampling, concat fusion; see
config.py).  Layout: NCHW-shaped tensors in channels_last memory, so
memory stays NHWC as in the JAX package and as the GroupNorm+ELU kernel
expects; fp32 parameters; compute in ``cfg.compute_dtype``; the depth
head in fp32.

Attribute names follow the flax parameter paths (``Conv_0.kernel``,
``gn_scale``, ``up_kernel``, ``fuse.kernel``, ...) and conv kernels are
stored OIHW, so a state_dict from ``gdn_tpu.checkpoint.params_to_torch``
loads with ``strict=True`` and no key map.

Every GroupNorm+ELU site calls ``kernels.groupnorm.group_norm_elu``;
convolutions go to ``torch.nn.functional`` (cuDNN on the card), as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.kernels.groupnorm import group_norm_elu
from gdn_tpu_torch.ops.groupnorm import pick_groups
from gdn_tpu_torch.ops.resize import composed_resize_conv2x, resize_bilinear

GN_EPS = 1e-6
CL = torch.channels_last


def _param(*shape, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


def conv_same(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """XLA "SAME" convolution of NCHW x with an OIHW kernel.

    XLA pads total = max((ceil(n/s) - 1)*s + k - n, 0) with the extra
    row/column at the bottom/right: asymmetric at stride 2 (e.g. (0, 1)
    for n=128, k=3), which torch's symmetric ``padding=`` cannot say.
    """
    kh, kw = kernel.shape[2], kernel.shape[3]

    def pads(n, k):
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        return total // 2, total - total // 2

    (t, b), (l, r) = pads(x.shape[2], kh), pads(x.shape[3], kw)
    kernel = kernel.contiguous(memory_format=CL)
    if t == b and l == r:
        return F.conv2d(x, kernel, bias, stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), kernel, bias, stride)


def gn_elu(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           groups: int, cfg: ModelConfig) -> torch.Tensor:
    """GroupNorm + ELU epilogue of every block (the kernel on the card)."""
    y = y.to(cfg.compute_dtype).contiguous(memory_format=CL)
    return group_norm_elu(y, scale, bias, groups, GN_EPS)


class _ConvKernel(nn.Module):
    """Bare conv parameter holder, named ``Conv_0`` by its caller to keep
    the flax path ``.../Conv_0/kernel``."""

    def __init__(self, cin: int, cout: int, k: int, use_bias: bool = False):
        super().__init__()
        self.kernel = _param(cout, cin, k, k)
        self.bias = _param(cout) if use_bias else None


class ConvBlock(nn.Module):
    """Conv(k, k) -> GroupNorm -> ELU."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg, self.stride = cfg, stride
        self.groups = pick_groups(features, cfg.group_norm_groups)
        self.Conv_0 = _ConvKernel(cin, features, kernel)
        self.gn_scale = _param(features, fill=1.0)
        self.gn_bias = _param(features, fill=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        y = conv_same(x.to(dt), self.Conv_0.kernel.to(dt), self.stride)
        return gn_elu(y, self.gn_scale, self.gn_bias, self.groups, self.cfg)


class DownBlock(nn.Module):
    """Stride-2 conv + refining conv: one encoder scale (/2)."""

    def __init__(self, cin: int, features: int, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(cin, features, 3, 2, cfg)
        self.ConvBlock_1 = ConvBlock(features, features, 3, 1, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBlock_1(self.ConvBlock_0(x))


class FusionBlock(nn.Module):
    """Concat fusion: concat(x, lateral) -> conv3x3 -> GroupNorm -> ELU."""

    def __init__(self, cx: int, cl: int, features: int,
                 cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.groups = pick_groups(features, cfg.group_norm_groups)
        self.kernel = _param(features, cx + cl, 3, 3)
        self.scale = _param(features, fill=1.0)
        self.bias = _param(features, fill=0.0)

    def forward(self, x: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        full = torch.cat([x, lateral.to(x.dtype)], dim=1).to(dt)
        y = conv_same(full, self.kernel.to(dt))
        return gn_elu(y, self.scale, self.bias, self.groups, self.cfg)


class UpBlock(nn.Module):
    """One decoder scale: bilinear upsample to an exact target size,
    conv3x3 -> GroupNorm -> ELU, then concat fusion of the lateral.

    At an exact 2x target with H, W >= 2 (and ``resize_conv_composed``)
    the upsample and conv run as one composed transposed conv
    (ops/resize.py); otherwise resize (in the compute dtype) then conv.
    """

    def __init__(self, cin: int, features: int, lateral_channels: int,
                 cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.groups = pick_groups(features, cfg.group_norm_groups)
        self.up_kernel = _param(features, cin, 3, 3)
        self.up_scale = _param(features, fill=1.0)
        self.up_bias = _param(features, fill=0.0)
        self.fuse = FusionBlock(features, lateral_channels, features, cfg)

    def forward(self, x: torch.Tensor, target_hw: Tuple[int, int],
                lateral: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        h, w = x.shape[2], x.shape[3]
        k = self.up_kernel.to(dt)
        if (c.resize_conv_composed and tuple(target_hw) == (2 * h, 2 * w)
                and h >= 2 and w >= 2):
            y = composed_resize_conv2x(x.to(dt), k.contiguous(memory_format=CL))
        else:
            y = conv_same(resize_bilinear(x.to(dt), target_hw, precise=False), k)
        x = gn_elu(y, self.up_scale, self.up_bias, self.groups, c)
        if lateral is not None:
            x = self.fuse(x, lateral)
        return x


class DepthHead(nn.Module):
    """1-channel depth: fp32 conv3x3 -> sigmoid -> scale to (0, max_depth]."""

    def __init__(self, cin: int, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.max_depth = cfg.max_depth
        self.Conv_0 = _ConvKernel(cin, 1, 3, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_same(x.float(), self.Conv_0.kernel, 1, self.Conv_0.bias)
        return torch.sigmoid(y) * self.max_depth
