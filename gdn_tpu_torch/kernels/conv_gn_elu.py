"""Fused conv3x3 + GroupNorm + ELU: wrappers of the hand-written CUDA
kernels, and their plain PyTorch version.

Replaces three TPU kernels of ``gdn_tpu/kernels/conv_gn_elu.py``:
``fused_conv_gn_elu`` (per image, fp32 out, backward by recompute),
``fused_conv_gn_elu_bt`` (stride 1) and ``fused_conv_gn_elu_s2``
(stride 2), the last two emitting the residuals ``(a, yn, inv)`` of an
analytic backward.  ``kernels/fusion_bt.py`` and
``kernels/fusion_block.py`` drive the same kernels with two inputs,
``kernels/upsample.py`` with the bilinear 2x of x in front.  The CUDA
source (``csrc/conv_gn_elu.cu``) says what bounds the kernels and what
its two launches do about it.

Two K loops stand behind the entry points (``kernel_route``): all six
with bf16 taps take the tensor cores (``mma.sync`` on bf16 operands,
fp32 sums, as the TPU kernels on the MXU): the stride-1 and stride-2
ones (``fused_conv_gn_elu``, ``fused_conv_gn_elu_bt``,
``fused_conv_gn_elu_s2`` and the two-input ``fused_fusion_bt`` and
``fused_fusion_block``) through ``conv3x3_stats_tc`` (tile from
``tc_tile``, weights from ``pack_weight_tc``), ``fused_upsample_conv``
through ``conv3x3_stats_tc_up``, which blends a halo tile of the
upsampled map in shared memory once a channel chunk (tile from
``up_tile``, weights from ``pack_weight_up``).  fp32 taps, which are
exact fp32 in the JAX reference, take the FMA kernel.

The function: SAME 3x3 convolution of x and the weights, both rounded
to the tap dtype, accumulated in fp32; per-(image, group) single-pass
moments of that fp32 accumulator, the variance clamped at 0;
``yn = (acc - mean) * inv``, ``a = ELU(yn * scale + bias)``; fp32 until
the one store.  ``conv_gn_elu_plain`` is the same function through
``F.conv2d``; the CPU path and the card's smoke check use it (on the
card with ``torch.backends.cudnn.allow_tf32 = False``).

Layout, as everywhere in the port: x is (B, Cin, H, W) in channels_last
memory (NHWC, the JAX package's layout), weights are OIHW fp32.  Where
the TPU entry points take ``batch_tile`` and ``interpret``, these take
nothing: a CUDA block owns a tile of one image whatever the batch.

Where the gates differ from the TPU's: none of "channels % 128",
"W % pack factor", "even H" or a VMEM fit applies.  Any Cin, any
Cout <= 1024 divisible by ``groups``, any H and W (odd sizes at stride
2 included, with XLA's SAME padding) run the kernel.

Gradients: under grad every entry point runs inside an autograd
Function.  bt and s2 keep ``(x, w, scale, a, yn, inv)`` and their
backward is the JAX package's ``_analytic_bwd``: ELU' from the output,
the two-reduce GroupNorm backward (``ops.groupnorm.gn_elu_backward``),
then the standard convolution input and weight gradients (cuDNN; on the
TPU they are XLA's, outside any Pallas kernel).  ``fused_conv_gn_elu``
(and the fusion-block and upsample entry points) keep their inputs and
their backward is the VJP of the fp32 reference on them, as the TPU
kernels': whatever the tap dtype, the gradients are taken at the
unrounded inputs, in fp32 (``FusedRecompute``).  A CPU tensor runs the
plain version inside the same Functions; a CUDA tensor launches the
kernels or raises.  Without grad every entry point calls the registered
op ``gdn_tpu_torch::conv_gn_elu`` (``kernels/ops.py``), which runs the
same plain version or launch and which an exported graph holds.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from gdn_tpu_torch.kernels import build, ops
from gdn_tpu_torch.ops.conv import CL, conv_same, conv_same_backward, same_pads
from gdn_tpu_torch.ops.groupnorm import _chanreduce_stats, gn_elu_backward

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MAX_C = 1024
# Elements one block of the normalize launch covers; sets its chunk count.
_APPLY_ELEMS = 16384

Residuals = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, argtypes set."""
    lib = build.load("conv_gn_elu")
    fn, tc = lib.conv_gn_elu_forward, lib.conv_gn_elu_forward_tc
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 11 + [i] * 12 + [f] + [i] * 6 + [p]
        tc.argtypes = [p] * 10 + [i] * 12 + [f] + [i] * 6 + [p]
        fn.restype = tc.restype = ctypes.c_int
    return lib


def block_rows(cout: int) -> int:
    """Output pixels one block of the FMA kernel's conv launch owns (as
    the CUDA source's tiles: 256 x 16, 128 x 32 or 64 x 64 pixels x
    channels)."""
    return 256 if cout <= 16 else 128 if cout <= 32 else 64


def pack_weight(w: torch.Tensor, tap: torch.dtype) -> torch.Tensor:
    """OIHW (Cout, Cs, 3, 3) -> the FMA kernel's fp32 (9, Cs, Cout), tap
    major, values rounded to the tap dtype."""
    cout, cs = w.shape[:2]
    return (w.detach().to(tap).float().permute(2, 3, 1, 0).contiguous()
            .view(9, cs, cout))


def pad8(c: int) -> int:
    """A channel count rounded up to 8: one 16-byte copy of bf16."""
    return -(-c // 8) * 8


def pack_weight_tc(w: torch.Tensor, wl: Optional[torch.Tensor] = None) -> torch.Tensor:
    """OIHW (Cout, Cx, 3, 3) and, for two inputs, the lateral's half wl
    (Cout, Cl, 3, 3) -> the tensor-core kernel's bf16 (Cout, 9 * (Cx_p +
    Cl_p)), K-major: column (3 ky + kx) * (Cx_p + Cl_p) + c holds w's
    channel c below Cx_p and wl's channel c - Cx_p above, Cx_p and Cl_p
    the channel counts rounded up to 8 (the pad columns zero, so every
    16-byte copy of 8 channels is aligned and lies in one source), values
    rounded to bf16.  The halves may be strided slices of one kernel;
    each takes one cast-and-transpose copy on the card."""
    halves = [w] if wl is None else [w, wl]
    cout = w.shape[0]
    wk = torch.empty((cout, 3, 3, sum(pad8(h.shape[1]) for h in halves)),
                     dtype=torch.bfloat16, device=w.device)
    c0 = 0
    for h in halves:
        cs = h.shape[1]
        wk[..., c0:c0 + cs].copy_(h.detach().permute(0, 2, 3, 1))
        if cs % 8:
            wk[..., c0 + cs:c0 + pad8(cs)].zero_()
        c0 += pad8(cs)
    return wk.view(cout, -1)


UP_CHUNK = 32  # input channels a K step of the upsample kernel (one tap)
UP_TW = 16  # U columns of the upsample kernel's tile (BM / 16 rows)


def pack_weight_up(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the upsample kernel's bf16 (Cout, 9 *
    Cin_p), Cin_p = Cin rounded up to 32, channel chunk outer and tap
    inner: column (chunk * 9 + 3 ky + kx) * 32 + c holds w's channel
    chunk * 32 + c (zero past Cin), values rounded to bf16."""
    cout, cin = w.shape[:2]
    cin_p = -(-cin // UP_CHUNK) * UP_CHUNK
    wk = F.pad(w.detach().to(torch.bfloat16), (0, 0, 0, 0, 0, cin_p - cin))
    return (wk.view(cout, cin_p // UP_CHUNK, UP_CHUNK, 9).permute(0, 1, 3, 2)
            .reshape(cout, 9 * cin_p))


SMS = 132  # streaming multiprocessors of an H100
TC_TILES = tuple((bm, bn) for bm in (64, 128) for bn in (16, 32, 64, 128))


def _pick_tile(b: int, cout: int, tiles, mtiles: Callable[[int], int]) -> Tuple[int, int]:
    """The rule ``tc_tile`` states, over ``tiles`` (BN already within
    what Cout takes) for a map of ``mtiles(bm)`` m tiles an image."""
    def blocks(t):
        return b * mtiles(t[0]) * -(-cout // t[1])

    def padded(t):
        return mtiles(t[0]) * t[0] * -(-cout // t[1]) * t[1]

    tight = min(padded(t) for t in tiles)
    tiles = [t for t in tiles if padded(t) <= 1.1 * tight]
    full = [t for t in tiles if blocks(t) >= SMS]
    if full:
        return min(full, key=lambda t: (-t[0] * t[1], padded(t), -t[0]))
    return min(tiles, key=lambda t: (-blocks(t), padded(t), -t[0] * t[1]))


def _narrow(cout: int):
    """TC_TILES whose BN suits Cout: BN = 16 serves Cout <= 16 alone."""
    narrow = 16 if cout <= 16 else 32
    return [t for t in TC_TILES if narrow <= t[1] <= max(narrow, cout)]


def tc_tile(b: int, m: int, cin: int, cout: int,
            gather: bool = False) -> Tuple[int, int]:
    """(BM, BN) of the tensor-core kernel for ``b`` images of ``m``
    output pixels, ``cin`` K columns a tap (Cx_p + Cl_p: the input
    channels, each source's rounded up to 8) and ``cout`` output
    channels.  Where Cin % 64 == 0 the kernel takes 64 columns a K step,
    and only 64-row tiles (128 rows spill at that step); so do the
    register path's (``gather``: fp32 inputs, or a channel count % 8 !=
    0) tiles wider than 32 channels.  BN = 16 serves
    Cout <= 16 alone, so a deep site never trades its tile for thinner
    blocks.  Padded rows and columns are tensor-core work thrown away (a
    128-row tile over the 52 pixels of a 4x13 map wastes 59% of it), so
    only tiles that pad the output map at most 10% more than the
    tightest one are taken; of those, the largest (BN <= Cout where Cout
    allows) whose grid fills one wave of the card's SMs, ties to the
    less padded, then the taller.  Where none fills a wave, the one with
    the most blocks."""
    fits = [t for t in _narrow(cout)
            if t[0] == 64 or (cin % 64 and not (gather and t[1] > 32))]
    return _pick_tile(b, cout, fits, lambda bm: -(-m // bm))


def up_mtiles(ho: int, wo: int, bm: int) -> int:
    """U tiles of an image in the upsample kernel: BM / 16 rows x 16
    columns of the (ho, wo) map each."""
    return -(-ho // (bm // UP_TW)) * -(-wo // UP_TW)


def up_tile(b: int, ho: int, wo: int, cout: int,
            fp32_in: bool = False) -> Tuple[int, int]:
    """(BM, BN) of the upsample kernel for ``b`` images of a (ho, wo)
    map of U: ``tc_tile``'s rule over 2-D tiles.  Its K step is 32
    channels whatever Cin, so 128-row tiles are open at any Cin; with
    fp32 inputs (``fp32_in``) only to BN <= 32, as the register path's
    (wider ones spill: the blend holds four float4 loads)."""
    fits = [t for t in _narrow(cout) if t[0] == 64 or not (fp32_in and t[1] > 32)]
    return _pick_tile(b, cout, fits, lambda bm: up_mtiles(ho, wo, bm))


def apply_rows(b: int, m: int, cout: int) -> int:
    """Output rows one block of the normalize launch covers: at most
    ``_APPLY_ELEMS`` elements, and few enough rows that the grid holds
    two waves of blocks (each block folds its image's partials first,
    and at the deep sites a few large blocks left most SMs idle)."""
    return max(1, min(_APPLY_ELEMS // cout, b * m // (2 * SMS)))


def kernel_route(counter: Callable, tap_dtype: str) -> str:
    """Which K loop an entry point's launch runs: "tc" (tensor cores) for
    the six entry points with bf16 taps, "fma" for fp32 taps."""
    # the two-input and upsample modules import this one
    from gdn_tpu_torch.kernels.fusion_block import fused_fusion_block
    from gdn_tpu_torch.kernels.fusion_bt import fused_fusion_bt
    from gdn_tpu_torch.kernels.upsample import fused_upsample_conv

    tc_entries = (fused_conv_gn_elu, fused_conv_gn_elu_bt, fused_conv_gn_elu_s2,
                  fused_fusion_bt, fused_fusion_block, fused_upsample_conv)
    return "tc" if tap_dtype == "bfloat16" and counter in tc_entries else "fma"


def _check(x, lat, wx, wl, scale, bias, groups, tap_dtype):
    if tap_dtype not in _TAPS:
        raise ValueError(f"unknown tap_dtype {tap_dtype!r} (float32|bfloat16)")
    pairs = [("x", x, "w", wx)] + ([("lat", lat, "wl", wl)] if lat is not None else [])
    cout = wx.shape[0]
    for xn, v, wn, k in pairs:
        if v.dim() != 4 or k.dim() != 4:
            raise ValueError(f"{xn} must be (B, C, H, W) and {wn} (Cout, C, 3, 3), got "
                             f"{tuple(v.shape)}, {tuple(k.shape)}")
        if tuple(k.shape) != (cout, v.shape[1], 3, 3):
            raise ValueError(f"{wn} must be ({cout}, {v.shape[1]}, 3, 3), got "
                             f"{tuple(k.shape)}")
        if v.dtype not in _DTYPES:
            raise TypeError(f"{xn} dtype {v.dtype} not supported (float32|bfloat16)")
        if v.device != x.device or k.device != x.device:
            raise ValueError("inputs and weights must lie on one device")
    if lat is not None and (lat.shape[0] != x.shape[0] or lat.shape[2:] != x.shape[2:]
                            or lat.dtype != x.dtype):
        raise ValueError(f"lat {tuple(lat.shape)} {lat.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if groups < 1 or cout % groups:
        raise ValueError(f"Cout={cout} is not divisible by groups={groups}")
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"scale/bias must be ({cout},), got {tuple(scale.shape)}, "
                         f"{tuple(bias.shape)}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must lie on one device")


def conv_gn_elu_plain(x, w, scale, bias, groups: int = 8, eps: float = 1e-6,
                      stride: int = 1, tap_dtype: str = "float32",
                      out_dtype: Optional[torch.dtype] = None,
                      lat=None, wl=None) -> Residuals:
    """Plain version of every kernel of the family -> (a, yn, inv): a and
    yn (B, Cout, Ho, Wo) in ``out_dtype`` (x's by default), inv (B, Cout)
    fp32.  Differentiable by autograd in every tensor argument."""
    tap = _TAPS[tap_dtype]

    def conv(v, k):
        return conv_same(v.to(tap).float(), k.to(tap).float(), stride)

    y = conv(x, w)
    if lat is not None:
        y = y + conv(lat, wl)
    mean_c, inv_c = _chanreduce_stats(y, groups, eps)
    yn = (y - mean_c[:, :, None, None]) * inv_c[:, :, None, None]
    a = F.elu(yn * scale.float()[:, None, None] + bias.float()[:, None, None])
    out_dtype = out_dtype or x.dtype
    return (a.to(out_dtype).contiguous(memory_format=CL),
            yn.to(out_dtype).contiguous(memory_format=CL), inv_c)


def _launch(counter: Callable, x, lat, wx, wl, scale, bias, groups, eps, stride,
            tap_dtype, out_dtype, residuals: bool, upsample: bool = False,
            route: Optional[str] = None) -> Residuals:
    """Run the kernels on CUDA tensors; adds one to ``counter.launches``.
    ``upsample`` convolves the bilinear 2x of x (one input, stride 1),
    which the kernels blend in shared memory or registers and never
    store.  ``route`` ("tc" or "fma") overrides ``kernel_route``: the
    smoke check times the FMA kernel beside the tensor-core one with it."""
    route = route or kernel_route(counter, tap_dtype)
    if route not in ("tc", "fma"):
        raise ValueError(f"unknown route {route!r} (tc|fma)")
    if route == "tc" and (tap_dtype != "bfloat16" or stride not in (1, 2)
                          or (upsample and stride != 1)
                          or (lat is not None and (stride != 1 or upsample))):
        raise ValueError("the tensor-core kernel takes bf16 taps, stride 1 or 2, the "
                         "upsample at stride 1, and a lateral at stride 1 without it")
    b, cx, h, w = x.shape
    cl = 0 if lat is None else lat.shape[1]
    cout = wx.shape[0]
    if cout > _MAX_C:
        raise ValueError(f"Cout={cout} exceeds the kernel's limit of {_MAX_C}")
    for name, v in (("x", x), ("lat", lat)):
        if v is None:
            continue
        if not v.is_contiguous(memory_format=CL):
            raise ValueError(f"{name} must be channels_last contiguous (NHWC memory)")
        if v.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    tap = _TAPS[tap_dtype]
    if upsample:
        ho, wo, pad_top, pad_left = 2 * h, 2 * w, 1, 1
    else:
        ho, wo = -(-h // stride), -(-w // stride)
        pad_top, pad_left = same_pads(h, 3, stride)[0], same_pads(w, 3, stride)[0]
    m = ho * wo
    gather = x.dtype != torch.bfloat16 or cx % 8 != 0 or cl % 8 != 0  # register path
    if route == "fma":
        bm, bn = block_rows(cout), None
    elif upsample:
        bm, bn = up_tile(b, ho, wo, cout, x.dtype == torch.float32)
    else:
        bm, bn = tc_tile(b, m, pad8(cx) + pad8(cl), cout, gather)
    mtiles = up_mtiles(ho, wo, bm) if route == "tc" and upsample else -(-m // bm)
    dev = x.device
    scale32 = scale.detach().float().contiguous()
    bias32 = bias.detach().float().contiguous()
    y = torch.empty((b, m, cout), dtype=torch.float32, device=dev)
    partials = torch.empty((b, mtiles, cout, 2), dtype=torch.float32, device=dev)
    a = torch.empty((b, cout, ho, wo), dtype=out_dtype, device=dev, memory_format=CL)
    yn = torch.empty_like(a) if residuals else None
    inv = torch.empty((b, cout), dtype=torch.float32, device=dev) if residuals else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    rows_per_chunk = apply_rows(b, m, cout)
    if route == "tc":
        wk = (pack_weight_up(wx) if upsample
              else pack_weight_tc(wx, wl if lat is not None else None))
        err = load().conv_gn_elu_forward_tc(
            ptr(x), ptr(lat), ptr(wk), ptr(scale32), ptr(bias32), ptr(y), ptr(partials),
            ptr(a), ptr(yn), ptr(inv), b, h, w, cx, cl, cout, ho, wo, stride, pad_top,
            pad_left, groups, float(eps), _DTYPES[x.dtype], _DTYPES[out_dtype], bm, bn,
            rows_per_chunk, int(upsample), stream)
    else:
        wxp = pack_weight(wx, tap)
        wlp = pack_weight(wl, tap) if lat is not None else None
        err = load().conv_gn_elu_forward(
            ptr(x), ptr(lat), ptr(wxp), ptr(wlp), ptr(scale32), ptr(bias32), ptr(y),
            ptr(partials), ptr(a), ptr(yn), ptr(inv),
            b, h, w, cx, cl, cout, ho, wo, stride,
            pad_top, pad_left, groups, float(eps), _DTYPES[x.dtype], _DTYPES[out_dtype],
            int(tap == torch.bfloat16 and (upsample or x.dtype == torch.float32)), bm,
            rows_per_chunk, int(upsample), stream)
    if err != 0:
        raise RuntimeError(f"conv_gn_elu_forward ({route}) failed: cudaError {err}")
    counter.launches += 1
    return a, yn, inv


def forward_all(counter: Callable, x, lat, wx, wl, scale, bias, groups, eps, stride,
                tap_dtype, out_dtype, residuals: bool) -> Residuals:
    """(a, yn, inv) of checked arguments: the plain version for CPU
    tensors, the kernels for CUDA tensors (or an error)."""
    if x.device.type == "cpu":
        return conv_gn_elu_plain(x, wx, scale, bias, groups, eps, stride, tap_dtype,
                                 out_dtype, lat, wl)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(counter, x, lat, wx, wl, scale, bias, groups, eps, stride,
                   tap_dtype, out_dtype, residuals)


class FusedConvGNELUAnalytic(torch.autograd.Function):
    """Forward by ``forward_all`` with residuals; analytic backward (the
    JAX package's ``_analytic_bwd`` / ``_fb_bwd``).  ``lat``/``wl`` are
    None for one input."""

    @staticmethod
    def forward(ctx, counter, x, lat, wx, wl, scale, bias, groups, eps, stride,
                tap_dtype):
        a, yn, inv = forward_all(counter, x, lat, wx, wl, scale, bias, groups, eps,
                                 stride, tap_dtype, x.dtype, True)
        ctx.save_for_backward(x, lat, wx, wl, scale, a, yn, inv)
        ctx.groups, ctx.stride = groups, stride
        return a

    @staticmethod
    def backward(ctx, da):
        x, lat, wx, wl, scale, a, yn, inv = ctx.saved_tensors
        dt = yn.dtype
        dy, dscale, dbias = gn_elu_backward(da, yn, inv, scale, None, ctx.groups, a=a)
        need = ctx.needs_input_grad
        dx, dwx = conv_same_backward(dy, x, wx.to(dt), ctx.stride, need[1], need[3])
        dlat = dwl = None
        if lat is not None:
            dlat, dwl = conv_same_backward(dy, lat, wl.to(dt), 1, need[2], need[4])
            dwl = None if dwl is None else dwl.to(wl.dtype)
        dwx = None if dwx is None else dwx.to(wx.dtype)
        return (None, dx, dlat, dwx, dwl, dscale.to(scale.dtype),
                dbias.to(scale.dtype), None, None, None, None)


class FusedRecompute(torch.autograd.Function):
    """The fp32-out entry points without residuals (``fused_conv_gn_elu``,
    ``fused_fusion_block``, ``fused_upsample_conv``): ``forward(*tensors)``
    is the kernel (or, on the CPU, its plain version) at the tap dtype;
    the backward is the VJP of ``reference(*tensors)``, the same function
    in fp32 on the saved, unrounded inputs, as the JAX package's
    ``custom_vjp``s.  An input that needs no gradient (a frozen weight)
    gets none computed."""

    @staticmethod
    def forward(ctx, forward, reference, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.reference = reference
        return forward(*tensors)

    @staticmethod
    def backward(ctx, da):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.reference(*ins)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(ins, need) if n], da))
        return (None, None, *[next(grads) if n else None for n in need])


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def fused_conv_gn_elu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int = 8, eps: float = 1e-6,
                      tap_dtype: str = "float32") -> torch.Tensor:
    """Fused conv3x3 (stride 1, SAME) + GroupNorm + ELU.

    x (B, Cin, H, W) channels_last, fp32 or bf16; w (Cout, Cin, 3, 3);
    scale, bias (Cout,).  Returns (B, Cout, H, W) float32."""
    _check(x, None, w, None, scale, bias, groups, tap_dtype)

    def forward(x, w, scale, bias):
        return forward_all(fused_conv_gn_elu, x, None, w, None, scale, bias, groups, eps,
                           1, tap_dtype, torch.float32, False)[0]

    def reference(x, w, scale, bias):
        return conv_gn_elu_plain(x, w, scale, bias, groups, eps, 1, "float32",
                                 torch.float32)[0]

    if needs_grad(x, w, scale, bias):
        return FusedRecompute.apply(forward, reference, x, w, scale, bias)
    return ops.conv_gn_elu("fused_conv_gn_elu", x, None, w, None, scale, bias, groups,
                           eps, 1, False, tap_dtype, torch.float32)


def _analytic_entry(counter, x, w, scale, bias, groups, eps, stride, tap_dtype):
    _check(x, None, w, None, scale, bias, groups, tap_dtype)
    if needs_grad(x, w, scale, bias):
        return FusedConvGNELUAnalytic.apply(counter, x, None, w, None, scale, bias,
                                            groups, eps, stride, tap_dtype)
    return ops.conv_gn_elu(counter.__name__, x, None, w, None, scale, bias, groups, eps,
                           stride, False, tap_dtype, x.dtype)


def fused_conv_gn_elu_bt(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int = 8, eps: float = 1e-6,
                         tap_dtype: str = "bfloat16") -> torch.Tensor:
    """Fused conv3x3 (stride 1, SAME) + GroupNorm + ELU with the analytic
    backward.  Arguments as ``fused_conv_gn_elu``; returns (B, Cout, H, W)
    in x's dtype."""
    return _analytic_entry(fused_conv_gn_elu_bt, x, w, scale, bias, groups, eps, 1,
                           tap_dtype)


def fused_conv_gn_elu_s2(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int = 8, eps: float = 1e-6,
                         tap_dtype: str = "bfloat16") -> torch.Tensor:
    """Fused conv3x3 (stride 2, XLA's SAME padding) + GroupNorm + ELU with
    the analytic backward.  Returns (B, Cout, ceil(H/2), ceil(W/2)) in
    x's dtype; H and W may be odd."""
    return _analytic_entry(fused_conv_gn_elu_s2, x, w, scale, bias, groups, eps, 2,
                           tap_dtype)


def _conv_gn_elu_bt_all(x, w, scale, bias, groups=8, eps=1e-6,
                        tap_dtype="bfloat16") -> Residuals:
    """``fused_conv_gn_elu_bt``'s forward with its residuals (a, yn, inv)."""
    _check(x, None, w, None, scale, bias, groups, tap_dtype)
    return forward_all(fused_conv_gn_elu_bt, x, None, w, None, scale, bias, groups, eps,
                       1, tap_dtype, x.dtype, True)


def _conv_gn_elu_s2_all(x, w, scale, bias, groups=8, eps=1e-6,
                        tap_dtype="bfloat16") -> Residuals:
    """``fused_conv_gn_elu_s2``'s forward with its residuals (a, yn, inv)."""
    _check(x, None, w, None, scale, bias, groups, tap_dtype)
    return forward_all(fused_conv_gn_elu_s2, x, None, w, None, scale, bias, groups, eps,
                       2, tap_dtype, x.dtype, True)


fused_conv_gn_elu.launches = 0
fused_conv_gn_elu_bt.launches = 0
fused_conv_gn_elu_s2.launches = 0
