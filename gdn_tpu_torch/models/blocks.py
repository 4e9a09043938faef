"""Building blocks of the D-net / G-net encoder-decoders.

Port of ``gdn_tpu/models/blocks.py``, every variant of it (see
config.py).  Layout: NCHW-shaped tensors in channels_last memory, so
memory stays NHWC as in the JAX package and as the GroupNorm+ELU kernel
expects; fp32 parameters; compute in ``cfg.compute_dtype``; the depth
head in fp32.

Attribute names follow the flax parameter paths (``Conv_0.kernel``,
``gn_scale``, ``up_kernel``, ``fuse.kernel``, ``ConvTranspose_0.kernel``,
``fuse.lateral_proj.bias``, ...) and every 4-D kernel is stored as
``gdn_tpu.checkpoint.params_to_torch`` writes it (HWIO -> OIHW; a
ConvTranspose's (kh, kw, cin, cout) thus becomes (cout, cin, kh, kw)),
so its state_dict loads with ``strict=True`` and no key map.

With ``norm="group"`` every GroupNorm site with ELU calls
``kernels.groupnorm.group_norm_elu`` after a convolution from
``torch.nn.functional`` (cuDNN on the card, as the JAX package leaves
it to XLA), unless the config sends it to a fused
conv3x3+GroupNorm+ELU kernel: the 3x3 ConvBlocks by
``use_pallas_convgn_s2`` / ``use_pallas_convgn_bt`` /
``use_pallas_convgn`` (the JAX package's precedence), the concat
FusionBlocks by ``use_pallas_fusion_bt`` and then ``use_pallas_fusion``,
and the resize_conv UpBlock's up-conv, at an exact 2x target, by
``use_pallas_fusion`` (the upsample kernel: bilinear 2x + conv3x3 +
GroupNorm + ELU).  The 7x7 stem always takes the unfused route.  With
another activation a GroupNorm site runs the plain
``ops.groupnorm.group_norm_act`` (``gn_impl``'s formulation) and no
fused route is taken, as in the JAX package: its kernels compute ELU
only.  ``norm="none"`` blocks are a biased conv and the activation.

The deconv UpBlock is ``F.conv_transpose2d`` (cuDNN, as the JAX package
leaves ``nn.ConvTranspose`` to XLA): flax's transposed conv correlates
the stride-dilated input with the kernel unflipped at SAME pads (3, 3)
for 6x6 and (2, 2) for 4x4, and torch's correlates with the kernel
flipped at pads k - 1 - padding, so the kernel goes in as
``k.transpose(0, 1).flip(2, 3)`` with padding 2 (6x6) or 1 (4x4).

Under ``quant="int8"`` (post-training, ``ops/quant.py``) every fused
conv route and the composed up-conv are off, as the JAX package gates
them on ``quant == "none"``, and each conv whose input has at least
``quant_min_channels`` channels runs ``conv2d_int8``: the ConvBlocks
(the add FusionBlock's ``ConvBlock_0`` too), the concat FusionBlock's
conv and the resize_conv UpBlock's resize-then-conv.  The transposed
conv and ``lateral_proj`` stay in float.  Such a site holds its
activation scale in a non-persistent buffer ``x_scale`` (so its key is
the flax path of the JAX package's ``"quant"`` collection) and its
``calibrating`` flag, which ``ops.quant.calibrate_quant`` sets.  The
GroupNorm+ELU kernel stays on at every site.

Placed on a mesh with a ``"model"`` or ``"spatial"`` dim
(``parallel.mesh.shard_state``), a block carries ``tp`` (it holds a
slice of its output channels) and ``sp`` (it takes this rank's image
rows).  Every GroupNorm site then runs as one site of
``parallel.tensor`` (the conv on the whole input and the weight slice,
the epilogue on the slice, the channels gathered), and every site
without GroupNorm (the biased ``norm="none"`` convs, the deconv's bare
activation, ``lateral_proj``) likewise with its bias sliced
(``_plain_site``); its conv, transposed conv, resize and GroupNorm
statistics (any activation) take the height-sharded forms of
``parallel.spatial`` and ``kernels.groupnorm.group_norm_elu_rows``.
Under ``sp`` each forward takes ``rows``, the global height of its
input (a rank's shard does not show it; None: an even split), which
the encoder and decoder carry down.  A fused conv kernel has no halo
form: under ``sp`` the rows are gathered around it and split again.
Without either, a block runs as on one device, launch for launch.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.kernels.conv_gn_elu import (
    fused_conv_gn_elu, fused_conv_gn_elu_bt, fused_conv_gn_elu_s2,
)
from gdn_tpu_torch.kernels.fusion_block import fused_fusion_block
from gdn_tpu_torch.kernels.fusion_bt import fused_fusion_bt
from gdn_tpu_torch.kernels.groupnorm import group_norm_elu, group_norm_elu_rows
from gdn_tpu_torch.kernels.upsample import fused_upsample_conv
from gdn_tpu_torch.ops.conv import CL, conv_same
from gdn_tpu_torch.ops.elu import elu_saveout
from gdn_tpu_torch.ops.groupnorm import group_norm_act, group_norm_act_rows, pick_groups
from gdn_tpu_torch.ops.quant import conv2d_int8, init_act_scale
from gdn_tpu_torch.ops.resize import composed_resize_conv2x, resize_bilinear
from gdn_tpu_torch.parallel.spatial import (
    conv_rows, conv_transpose_rows, gather_rows, resize_rows, rows_of, split_rows,
)
from gdn_tpu_torch.parallel.tensor import (
    column_fused, column_site, copy_to_model, gather_from_model,
)

GN_EPS = 1e-6


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation flax's ``nn.<name>`` computes: flax's gelu is the
    tanh approximation, its leaky_relu here has slope 0.2."""
    return {
        "elu": F.elu,
        "relu": F.relu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.2),
    }[name]


def _param(*shape, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


def gn_act(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           groups: int, cfg: ModelConfig, sp=None, rows: Optional[int] = None) -> torch.Tensor:
    """GroupNorm + activation epilogue of a block: ELU on the GroupNorm+ELU
    kernel, any other activation through the plain ``group_norm_act``;
    under ``sp`` each in its split form on this rank's rows of an image
    of ``rows`` rows (statistics summed over the axis)."""
    y = y.to(cfg.compute_dtype).contiguous(memory_format=CL)
    if cfg.activation == "elu":
        if sp is not None:
            return group_norm_elu_rows(y, scale, bias, groups, GN_EPS, sp, rows)
        return group_norm_elu(y, scale, bias, groups, GN_EPS)
    if sp is not None:
        return group_norm_act_rows(y, scale, bias, groups, activation_fn(cfg.activation),
                                   cfg.gn_impl, GN_EPS, sp, rows_of(y, sp, rows))
    return group_norm_act(y, scale, bias, groups, activation_fn(cfg.activation),
                          cfg.gn_impl, GN_EPS)


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, sp=None,
          bias: Optional[torch.Tensor] = None, rows: Optional[int] = None,
          groups: int = 1) -> torch.Tensor:
    """``conv_same``, or under ``sp`` its form on this rank's rows of an
    image of ``rows`` rows."""
    if sp is None:
        return conv_same(x, kernel, stride, bias, groups)
    return conv_rows(x, kernel, stride, sp, rows, bias, groups)


def _rows(block: nn.Module, x: torch.Tensor, rows: Optional[int], stride: int = 1):
    """Under ``sp`` the global height of ``block``'s output for an input x
    of ``rows`` rows at ``stride`` (SAME: ceil(rows / stride)); None
    otherwise."""
    sp = getattr(block, "sp", None)
    return None if sp is None else -(-rows_of(x, sp, rows) // stride)


def _site(block: nn.Module, conv: Callable, xs, scale: torch.Tensor,
          bias: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """A GroupNorm site: ``conv(xs)`` then the epilogue (on an output of
    ``rows`` rows under ``sp``); column-parallel
    (``parallel.tensor.column_site``) where the block holds a slice."""
    tp, sp, cfg = getattr(block, "tp", None), getattr(block, "sp", None), block.cfg

    def epilogue(y, s, b, g):
        return gn_act(y, s, b, g, cfg, sp, rows)

    if tp is None:
        return epilogue(conv(xs), scale, bias, block.groups)
    return column_site(tp, conv, epilogue, xs, scale, bias, block.groups)


def _plain_site(block: nn.Module, conv: Callable, xs,
                act: Optional[Callable] = None) -> torch.Tensor:
    """A site without GroupNorm: ``conv(xs)`` (biased), then ``act``
    where given.  Where the block holds a slice of the output channels
    (and of the bias), the conv runs on the whole inputs and the slices
    are gathered after the activation (elementwise: it runs on the
    slice)."""
    tp = getattr(block, "tp", None)
    if tp is not None:
        xs = [copy_to_model(x, tp) for x in xs]
    y = conv(xs)
    y = y if act is None else act(y)
    return y if tp is None else gather_from_model(y, tp)


def _fused_site(block: nn.Module, call: Callable, xs, ws, scale: torch.Tensor,
                bias: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """A fused conv+GroupNorm+ELU kernel ``call(xs, ws, scale, bias,
    groups)`` as a site: column-parallel where the block holds a slice,
    and under ``sp`` on the whole image's rows (``rows`` of them),
    gathered around the call and split again."""
    tp, sp = getattr(block, "tp", None), getattr(block, "sp", None)
    if sp is not None:
        xs = [gather_rows(x, sp, rows) for x in xs]
    if tp is None:
        out = call(xs, ws, scale, bias, block.groups)
    else:
        out = column_fused(tp, call, xs, ws, scale, bias, block.groups)
    return out if sp is None else split_rows(out, sp)


def _fusable(cfg: ModelConfig) -> bool:
    """Whether a GroupNorm site may take a fused kernel at all: the JAX
    package's gates (Pallas on, no int8, GroupNorm, ELU)."""
    return (cfg.use_pallas and cfg.quant == "none" and cfg.norm == "group"
            and cfg.activation == "elu")


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
    """Bare conv parameter holder, named ``Conv_0`` (``ConvTranspose_0``,
    ``lateral_proj``) by its caller to keep the flax path
    ``.../Conv_0/kernel``."""

    def __init__(self, cin: int, cout: int, k: int, use_bias: bool = False):
        super().__init__()
        self.kernel = _param(cout, cin, k, k)
        self.bias = _param(cout) if use_bias else None


class ConvBlock(nn.Module):
    """Conv(k, k) -> GroupNorm -> activation, or with ``norm="none"`` a
    biased conv -> activation."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg, self.stride, self.kernel_size = cfg, stride, kernel
        self.use_gn = cfg.norm == "group"
        self.Conv_0 = _ConvKernel(cin, features, kernel, use_bias=not self.use_gn)
        self.quantized = False
        if self.use_gn:
            self.groups = pick_groups(features, cfg.group_norm_groups)
            self.gn_scale = _param(features, fill=1.0)
            self.gn_bias = _param(features, fill=0.0)
            self.quantized = _int8_site(self, cin, cfg)

    def _fused(self):
        """The fused kernel this block's config and shape select, in the
        JAX package's order (s2, then bt, then the per-image one), or
        None for the conv + GroupNorm+ELU route."""
        c = self.cfg
        if not _fusable(c) or self.kernel_size != 3:
            return None
        if self.stride == 2:
            return fused_conv_gn_elu_s2 if c.use_pallas_convgn_s2 else None
        if self.stride != 1:
            return None
        if c.use_pallas_convgn_bt:
            return fused_conv_gn_elu_bt
        return fused_conv_gn_elu if c.use_pallas_convgn else None

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        """``rows``: under ``sp``, the global height of x (None: an even
        split of it)."""
        c = self.cfg
        dt = c.compute_dtype
        sp = getattr(self, "sp", None)
        if not self.use_gn:
            k, b = self.Conv_0.kernel, self.Conv_0.bias
            return _plain_site(self, lambda xs: _conv(xs[0].to(dt), k.to(dt), self.stride, sp,
                                                      b.to(dt), rows),
                               [x], activation_fn(c.activation))
        fused = self._fused()
        if fused is not None:
            def call(xs, ws, scale, bias, groups):
                return fused(xs[0].to(dt).contiguous(memory_format=CL), ws[0], scale, bias,
                             groups, GN_EPS, c.dtype).to(dt)

            return _fused_site(self, call, [x], [self.Conv_0.kernel], self.gn_scale,
                               self.gn_bias, rows)
        if self.quantized:
            y = _conv_int8(self, x, self.Conv_0.kernel, self.stride).to(dt)
            return gn_act(y, self.gn_scale, self.gn_bias, self.groups, c)
        return _site(self, lambda xs: _conv(xs[0].to(dt), self.Conv_0.kernel.to(dt),
                                            self.stride, sp, rows=rows),
                     [x], self.gn_scale, self.gn_bias, _rows(self, x, rows, self.stride))


class DownBlock(nn.Module):
    """Stride-2 conv + refining conv: one encoder scale (/2)."""

    def __init__(self, cin: int, features: int, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(cin, features, 3, 2, cfg)
        self.ConvBlock_1 = ConvBlock(features, features, 3, 1, cfg)

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        return self.ConvBlock_1(self.ConvBlock_0(x, rows), _rows(self.ConvBlock_0, x, rows, 2))


class FusionBlock(nn.Module):
    """Merge a lateral feature map into the decoder stream.

    ``fusion="concat"``: concat(x, lateral) -> conv3x3 -> GroupNorm ->
    activation (with ``norm="none"``: conv3x3 -> + bias -> activation).
    ``use_pallas_fusion_bt`` sends a GroupNorm+ELU one to
    ``fused_fusion_bt``, else ``use_pallas_fusion`` to
    ``fused_fusion_block`` (the JAX package's order); neither builds the
    concatenated tensor.  ``fusion="add"``: a 1x1 ``lateral_proj`` (with
    bias) of the lateral is added to x, then ``ConvBlock_0``, which takes
    the ConvBlock routes (the bt kernel under ``use_pallas_convgn_bt``)."""

    def __init__(self, cx: int, cl: int, features: int,
                 cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.quantized = False
        if cfg.fusion == "add":
            self.lateral_proj = _ConvKernel(cl, cx, 1, use_bias=True)
            self.ConvBlock_0 = ConvBlock(cx, features, 3, 1, cfg)
            return
        self.use_gn = cfg.norm == "group"
        self.kernel = _param(features, cx + cl, 3, 3)
        if self.use_gn:
            self.groups = pick_groups(features, cfg.group_norm_groups)
            self.scale = _param(features, fill=1.0)
            self.quantized = _int8_site(self, cx + cl, cfg)
        self.bias = _param(features, fill=0.0)

    def forward(self, x: torch.Tensor, lateral: torch.Tensor,
                rows: Optional[int] = None) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        sp = getattr(self, "sp", None)
        if c.fusion == "add":
            p = self.lateral_proj
            proj = _plain_site(self, lambda xs: _conv(xs[0].to(dt), p.kernel.to(dt), 1, sp,
                                                      p.bias.to(dt), rows), [lateral])
            return self.ConvBlock_0(x + proj, rows)
        fused = None
        if _fusable(c) and c.use_pallas_fusion_bt:
            fused = fused_fusion_bt
        elif _fusable(c) and c.use_pallas_fusion:
            fused = fused_fusion_block
        if fused is not None:
            cx = x.shape[1]

            def call(xs, ws, scale, bias, groups):
                return fused(xs[0].to(dt).contiguous(memory_format=CL),
                             xs[1].to(dt).contiguous(memory_format=CL),
                             ws[0][:, :cx], ws[0][:, cx:], scale, bias, groups, GN_EPS,
                             c.dtype).to(dt)

            return _fused_site(self, call, [x, lateral], [self.kernel], self.scale, self.bias,
                               rows)

        def conv(xs):
            full = torch.cat([xs[0], xs[1].to(xs[0].dtype)], dim=1)
            return _conv(full.to(dt), self.kernel.to(dt), 1, sp, rows=rows)

        if self.use_gn and not self.quantized:
            return _site(self, conv, [x, lateral], self.scale, self.bias, _rows(self, x, rows))
        if not self.use_gn:
            return _plain_site(
                self, lambda xs: conv(xs) + self.bias.to(dt)[:, None, None], [x, lateral],
                activation_fn(c.activation))
        full = torch.cat([x, lateral.to(x.dtype)], dim=1)
        y = _conv_int8(self, full, self.kernel, 1).to(dt)
        return gn_act(y, self.scale, self.bias, self.groups, c)


class UpBlock(nn.Module):
    """One decoder scale: a 2x upsample to an exact target size, then the
    fusion of the lateral.  Three branches, as in the JAX package:

    - resize_conv with GroupNorm: bilinear resize, conv3x3 -> GroupNorm
      -> activation, its own ``up_kernel`` / ``up_scale`` / ``up_bias``.
      At an exact 2x target ``use_pallas_fusion`` (with ELU) sends the
      four to the upsample kernel as one call; otherwise, at an exact 2x
      target with H, W >= 2 (and ``resize_conv_composed``) the upsample
      and conv run as one composed transposed conv (ops/resize.py);
      otherwise resize (in the compute dtype) then conv.
    - resize_conv with ``norm="none"``: the fp32 bilinear resize, then
      ``ConvBlock_0``.
    - deconv: a stride-2 ``ConvTranspose_0`` (6x6 for the bilinear
      init, 4x4 for lecun; biased unless ``deconv_gn``), the bilinear
      resize to the target where the output misses it (it shrinks, and
      so antialiases, at NYU's odd sizes), then the GroupNorm epilogue
      (``deconv_gn``), or ELU through ``elu_saveout``
      (``elu_outform_vjp``), or the bare activation.
    """

    def __init__(self, cin: int, features: int, lateral_channels: int,
                 cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.quantized = False
        if cfg.upsample == "deconv":
            self.deconv_gn = cfg.norm == "group" and cfg.deconv_gn
            k = 6 if cfg.deconv_init == "bilinear" else 4
            self.ConvTranspose_0 = _ConvKernel(cin, features, k,
                                               use_bias=not self.deconv_gn)
            if self.deconv_gn:
                self.groups = pick_groups(features, cfg.group_norm_groups)
                self.deconv_gn_scale = _param(features, fill=1.0)
                self.deconv_gn_bias = _param(features, fill=0.0)
        elif cfg.norm != "group":
            self.ConvBlock_0 = ConvBlock(cin, features, 3, 1, cfg)
        else:
            self.groups = pick_groups(features, cfg.group_norm_groups)
            self.up_kernel = _param(features, cin, 3, 3)
            self.up_scale = _param(features, fill=1.0)
            self.up_bias = _param(features, fill=0.0)
            self.quantized = _int8_site(self, cin, cfg)
        self.fuse = FusionBlock(features, lateral_channels, features, cfg)

    def _deconv(self, x: torch.Tensor, target_hw: Tuple[int, int],
                rows: Optional[int]) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        sp = getattr(self, "sp", None)
        k, b = self.ConvTranspose_0.kernel, self.ConvTranspose_0.bias
        pad = 2 if k.shape[-1] == 6 else 1

        def conv(xs):
            w = k.to(dt).transpose(0, 1).flip(2, 3).contiguous(memory_format=CL)
            bb = None if b is None else b.to(dt)
            if sp is not None:
                return conv_transpose_rows(xs[0].to(dt), w, bb, pad, target_hw, sp, rows)
            y = F.conv_transpose2d(xs[0].to(dt), w, bb, stride=2, padding=pad)
            if tuple(y.shape[2:]) != tuple(target_hw):
                y = resize_bilinear(y, target_hw)
            return y

        if self.deconv_gn:
            return _site(self, conv, [x], self.deconv_gn_scale, self.deconv_gn_bias,
                         None if sp is None else target_hw[0])
        if c.activation == "elu" and c.elu_outform_vjp:
            return _plain_site(self, conv, [x], elu_saveout)
        return _plain_site(self, conv, [x], activation_fn(c.activation))

    def _resize_conv(self, x: torch.Tensor, target_hw: Tuple[int, int],
                     rows: Optional[int]) -> torch.Tensor:
        c = self.cfg
        dt = c.compute_dtype
        sp = getattr(self, "sp", None)
        h, w = (x.shape[2] if sp is None else rows_of(x, sp, rows)), x.shape[3]
        exact2x = tuple(target_hw) == (2 * h, 2 * w)
        plain = c.quant == "none"  # int8 takes resize then conv, as the JAX package
        if _fusable(c) and c.use_pallas_fusion and exact2x:
            def call(xs, ws, scale, bias, groups):
                return fused_upsample_conv(xs[0].to(dt).contiguous(memory_format=CL), ws[0],
                                           scale, bias, groups, GN_EPS, c.dtype).to(dt)

            return _fused_site(self, call, [x], [self.up_kernel], self.up_scale, self.up_bias,
                               rows)
        if self.quantized:
            u = resize_bilinear(x.to(dt), target_hw, precise=False)
            y = _conv_int8(self, u, self.up_kernel, 1).to(dt)
            return gn_act(y, self.up_scale, self.up_bias, self.groups, c)
        # the composed op has no halo form: on sharded rows, resize then conv
        if (c.resize_conv_composed and plain and exact2x and h >= 2 and w >= 2
                and sp is None):
            def conv(xs):
                k = self.up_kernel.to(dt)
                return composed_resize_conv2x(xs[0].to(dt), k.contiguous(memory_format=CL))
        elif sp is not None:
            def conv(xs):
                u = resize_rows(xs[0].to(dt), target_hw, sp, h, precise=False)
                return conv_rows(u, self.up_kernel.to(dt), 1, sp, target_hw[0])
        else:
            def conv(xs):
                u = resize_bilinear(xs[0].to(dt), target_hw, precise=False)
                return conv_same(u, self.up_kernel.to(dt))
        return _site(self, conv, [x], self.up_scale, self.up_bias,
                     None if sp is None else target_hw[0])

    def forward(self, x: torch.Tensor, target_hw: Tuple[int, int],
                lateral: Optional[torch.Tensor] = None,
                rows: Optional[int] = None) -> torch.Tensor:
        """``target_hw``: the skip's size; under ``sp`` the global one, and
        ``rows`` x's global height (None: an even split)."""
        sp = getattr(self, "sp", None)
        if self.cfg.upsample == "deconv":
            x = self._deconv(x, target_hw, rows)
        elif self.cfg.norm != "group":
            if sp is None:
                x = self.ConvBlock_0(resize_bilinear(x, target_hw))
            else:
                x = self.ConvBlock_0(resize_rows(x, target_hw, sp, rows), target_hw[0])
        else:
            x = self._resize_conv(x, target_hw, rows)
        if lateral is not None:
            x = self.fuse(x, lateral, None if sp is None else target_hw[0])
        return x


class DepthHead(nn.Module):
    """1-channel depth: fp32 conv3x3 -> sigmoid -> scale to (0, max_depth]."""

    def __init__(self, cin: int, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.max_depth = cfg.max_depth
        self.Conv_0 = _ConvKernel(cin, 1, 3, use_bias=True)

    def forward(self, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
        y = _conv(x.float(), self.Conv_0.kernel, 1, getattr(self, "sp", None),
                  self.Conv_0.bias, rows)
        return torch.sigmoid(y) * self.max_depth
