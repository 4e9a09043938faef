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

Every GroupNorm+ELU site calls ``kernels.groupnorm.group_norm_elu``
after a convolution from ``torch.nn.functional`` (cuDNN on the card, as
the JAX package leaves it to XLA), unless the config sends it to a
fused conv3x3+GroupNorm+ELU kernel: the 3x3 ConvBlocks by
``use_pallas_convgn_s2`` / ``use_pallas_convgn_bt`` /
``use_pallas_convgn`` (the JAX package's precedence), the FusionBlocks
by ``use_pallas_fusion_bt`` and then ``use_pallas_fusion``, and the
UpBlock's up-conv, at an exact 2x target, by ``use_pallas_fusion`` (the
upsample kernel: bilinear 2x + conv3x3 + GroupNorm + ELU).  The 7x7 stem
always takes the unfused route.

Under ``quant="int8"`` (post-training, ``ops/quant.py``) every fused
conv route and the composed up-conv are off, as the JAX package gates
them on ``quant == "none"``, and each conv whose input has at least
``quant_min_channels`` channels runs ``conv2d_int8``: the ConvBlocks, the
FusionBlock's concat conv and the UpBlock's resize-then-conv.  Such a
site holds its activation scale in a non-persistent buffer ``x_scale``
(so its key is the flax path of the JAX package's ``"quant"``
collection) and its ``calibrating`` flag, which ``ops.quant.
calibrate_quant`` sets.  The GroupNorm+ELU kernel stays on at every site.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.kernels.conv_gn_elu import (
    fused_conv_gn_elu, fused_conv_gn_elu_bt, fused_conv_gn_elu_s2,
)
from gdn_tpu_torch.kernels.fusion_block import fused_fusion_block
from gdn_tpu_torch.kernels.fusion_bt import fused_fusion_bt
from gdn_tpu_torch.kernels.groupnorm import group_norm_elu
from gdn_tpu_torch.kernels.upsample import fused_upsample_conv
from gdn_tpu_torch.ops.conv import CL, conv_same
from gdn_tpu_torch.ops.groupnorm import pick_groups
from gdn_tpu_torch.ops.quant import conv2d_int8, init_act_scale
from gdn_tpu_torch.ops.resize import composed_resize_conv2x, resize_bilinear

GN_EPS = 1e-6


def _param(*shape, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


def gn_elu(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           groups: int, cfg: ModelConfig) -> torch.Tensor:
    """GroupNorm + ELU epilogue of every block (the kernel on the card)."""
    y = y.to(cfg.compute_dtype).contiguous(memory_format=CL)
    return group_norm_elu(y, scale, bias, groups, GN_EPS)


def _int8_site(block: nn.Module, cin: int, cfg: ModelConfig) -> bool:
    """Make ``block`` an int8 conv site where ``cfg`` quantizes a conv of
    ``cin`` input channels: give it the 0-d buffer ``x_scale`` and the
    ``calibrating`` flag.  -> whether it did."""
    if cfg.quant != "int8" or cin < cfg.quant_min_channels:
        return False
    block.register_buffer("x_scale", torch.zeros(()), persistent=False)
    block.calibrating = False
    return True


def _conv_int8(block: nn.Module, x: torch.Tensor, kernel: torch.Tensor,
               stride: int) -> torch.Tensor:
    """``block``'s int8 conv of x at its scale; while calibrating, the
    scale is first set from x (absmax / 127), as the JAX package's
    ``"quant"`` variable initializes itself."""
    if block.calibrating:
        block.x_scale = init_act_scale(x)
    return conv2d_int8(x, kernel, stride, block.x_scale)


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
        self.cfg, self.stride, self.kernel_size = cfg, stride, kernel
        self.groups = pick_groups(features, cfg.group_norm_groups)
        self.Conv_0 = _ConvKernel(cin, features, kernel)
        self.gn_scale = _param(features, fill=1.0)
        self.gn_bias = _param(features, fill=0.0)
        self.quantized = _int8_site(self, cin, cfg)

    def _fused(self):
        """The fused kernel this block's config and shape select, in the
        JAX package's order (s2, then bt, then the per-image one), or
        None for the conv + GroupNorm+ELU route."""
        c = self.cfg
        if not c.use_pallas or c.quant != "none" or self.kernel_size != 3:
            return None
        if self.stride == 2:
            return fused_conv_gn_elu_s2 if c.use_pallas_convgn_s2 else None
        if self.stride != 1:
            return None
        if c.use_pallas_convgn_bt:
            return fused_conv_gn_elu_bt
        return fused_conv_gn_elu if c.use_pallas_convgn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        fused = self._fused()
        if fused is not None:
            out = fused(x.to(dt).contiguous(memory_format=CL), self.Conv_0.kernel,
                        self.gn_scale, self.gn_bias, self.groups, GN_EPS, c.dtype)
            return out.to(dt)
        if self.quantized:
            y = _conv_int8(self, x, self.Conv_0.kernel, self.stride).to(dt)
        else:
            y = conv_same(x.to(dt), self.Conv_0.kernel.to(dt), self.stride)
        return gn_elu(y, self.gn_scale, self.gn_bias, self.groups, c)


class DownBlock(nn.Module):
    """Stride-2 conv + refining conv: one encoder scale (/2)."""

    def __init__(self, cin: int, features: int, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(cin, features, 3, 2, cfg)
        self.ConvBlock_1 = ConvBlock(features, features, 3, 1, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBlock_1(self.ConvBlock_0(x))


class FusionBlock(nn.Module):
    """Concat fusion: concat(x, lateral) -> conv3x3 -> GroupNorm -> ELU.

    ``use_pallas_fusion_bt`` sends it to ``fused_fusion_bt``, else
    ``use_pallas_fusion`` to ``fused_fusion_block`` (the JAX package's
    order); neither builds the concatenated tensor."""

    def __init__(self, cx: int, cl: int, features: int,
                 cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.groups = pick_groups(features, cfg.group_norm_groups)
        self.kernel = _param(features, cx + cl, 3, 3)
        self.scale = _param(features, fill=1.0)
        self.bias = _param(features, fill=0.0)
        self.quantized = _int8_site(self, cx + cl, cfg)

    def forward(self, x: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        fused = None
        if c.use_pallas and c.quant == "none" and c.use_pallas_fusion_bt:
            fused = fused_fusion_bt
        elif c.use_pallas and c.quant == "none" and c.use_pallas_fusion:
            fused = fused_fusion_block
        if fused is not None:
            cx = x.shape[1]
            out = fused(
                x.to(dt).contiguous(memory_format=CL),
                lateral.to(dt).contiguous(memory_format=CL),
                self.kernel[:, :cx], self.kernel[:, cx:], self.scale, self.bias,
                self.groups, GN_EPS, c.dtype)
            return out.to(dt)
        full = torch.cat([x, lateral.to(x.dtype)], dim=1)
        if self.quantized:
            y = _conv_int8(self, full, self.kernel, 1).to(dt)
        else:
            y = conv_same(full.to(dt), self.kernel.to(dt))
        return gn_elu(y, self.scale, self.bias, self.groups, self.cfg)


class UpBlock(nn.Module):
    """One decoder scale: bilinear upsample to an exact target size,
    conv3x3 -> GroupNorm -> ELU, then concat fusion of the lateral.

    At an exact 2x target ``use_pallas_fusion`` sends upsample, conv,
    GroupNorm and ELU to the upsample kernel as one call.  Otherwise, at
    an exact 2x target with H, W >= 2 (and ``resize_conv_composed``) the
    upsample and conv run as one composed transposed conv (ops/resize.py);
    otherwise resize (in the compute dtype) then conv.
    """

    def __init__(self, cin: int, features: int, lateral_channels: int,
                 cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.groups = pick_groups(features, cfg.group_norm_groups)
        self.up_kernel = _param(features, cin, 3, 3)
        self.up_scale = _param(features, fill=1.0)
        self.up_bias = _param(features, fill=0.0)
        self.quantized = _int8_site(self, cin, cfg)
        self.fuse = FusionBlock(features, lateral_channels, features, cfg)

    def forward(self, x: torch.Tensor, target_hw: Tuple[int, int],
                lateral: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        h, w = x.shape[2], x.shape[3]
        exact2x = tuple(target_hw) == (2 * h, 2 * w)
        plain = c.quant == "none"  # int8 takes resize then conv, as the JAX package
        if c.use_pallas and c.use_pallas_fusion and plain and exact2x:
            x = fused_upsample_conv(
                x.to(dt).contiguous(memory_format=CL), self.up_kernel, self.up_scale,
                self.up_bias, self.groups, GN_EPS, c.dtype).to(dt)
        else:
            k = self.up_kernel.to(dt)
            if c.resize_conv_composed and plain and exact2x and h >= 2 and w >= 2:
                y = composed_resize_conv2x(x.to(dt), k.contiguous(memory_format=CL))
            else:
                u = resize_bilinear(x.to(dt), target_hw, precise=False)
                y = (_conv_int8(self, u, self.up_kernel, 1).to(dt) if self.quantized
                     else conv_same(u, k))
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
