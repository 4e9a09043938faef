"""GroupNorm+ELU: wrapper of the hand-written CUDA kernel.

Replaces the TPU kernel ``gdn_tpu/kernels/groupnorm.py::
fused_group_norm_elu``.  The kernel (``csrc/group_norm_elu.cu``) is
memory-bound and runs as one cooperative launch a call: blocks stage
slabs of one image's rows in shared memory, write their partial sums,
meet at a grid-wide barrier and normalize.  ``gn_plan`` decides the
slabs and the grid: held (one slab a block, x read once) where the
resident grid covers the tensor, else streamed (several slabs a block,
read again after the barrier).  Unlike the TPU kernel it needs no lane
packing and no VMEM gate, so it covers every GN site of the net (C =
16 ... 512, up to 1024).

Numerics: statistics in fp32 (single-pass, clamped at 0), then fp32
math until the one store in the input dtype, like the TPU kernel.  The
plain version (``ops/groupnorm.py::group_norm_elu_plain``) rounds the
mean and inverse to the compute dtype first, like the JAX package's
analytic form; in bf16 the two differ by a few bf16 ulps of the output
(held to atol 0.05, the JAX suite's bound for the same pair).

Gradient: where the input or the affine parameters require grad, the
kernel runs inside ``_GroupNormELUKernel``, an autograd Function that
keeps x and the fp32 (B, 2, G) mean and inverse std the kernel writes,
and whose backward is the JAX package's analytic two-reduce backward in
plain PyTorch (``ops.groupnorm.gn_elu_backward``; on the TPU that
backward is XLA, not a Pallas kernel).  Without grad (serving, the
frozen D-net) the call goes through the registered op
``gdn_tpu_torch::group_norm_elu`` (``kernels/ops.py``: the launch on
the card, so that an exported graph holds it) and nothing is kept.  On
the CPU every site runs ``group_norm_elu_analytic``.

Split form (``group_norm_elu_rows``), for an image whose rows are
sharded over a ``"spatial"`` mesh dim: one launch writes each slab's
per-group sums and, in the block that finishes an image last, folds them
in slab order to the image's (B, G, 2) sums; they are all-reduced over
the dim, and a second launch derives the statistics with the whole
image's count, writes them as (B, 2, G) and normalizes.  ``rows_plan``
sizes both grids to what the card holds at once.  Its backward all-reduces the two per-channel
reductions of the analytic backward the same way; the affine gradients
stay the rank's own (the step sums them over the ranks).  On the CPU
the same dataflow in plain PyTorch, with the analytic form's rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from gdn_tpu_torch.kernels import build, ops
from gdn_tpu_torch.ops.groupnorm import gn_elu_backward, group_norm_elu_analytic

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 1024
_THREADS = 256  # a block's threads, unless C / vec alone is more
_BLOCKS_PER_SM = 2  # the slab's shared memory is sized for two blocks an SM


class GnPlan(NamedTuple):
    grid: int  # blocks, all resident at once
    rows: int  # NHWC rows of one slab
    slabs_per_image: int
    slabs_per_block: int  # the most any block walks
    held: bool  # one slab a block, kept in shared memory across the barrier


def block_shape(c: int, vec: int):
    """(threads across = C / vec, rows at once) of one block."""
    px = c // vec
    return px, max(1, _THREADS // px)


def smem_bytes(c: int, groups: int, vec: int, slab_bytes: int) -> int:
    """Dynamic shared memory of one block: the slab, the (rows at once,
    C) fp32 channel sums and the 2 * G fp32 group statistics."""
    return slab_bytes + 4 * (block_shape(c, vec)[1] * c + 2 * groups)


def slab_capacity(c: int, groups: int, vec: int, smem_per_sm: int,
                  reserved_per_block: int) -> int:
    """Bytes of slab a block may stage, 16-byte aligned, so that two
    blocks fit an SM's shared memory (H100: 233,472 bytes an SM, 1,024
    reserved a block)."""
    per_block = smem_per_sm // _BLOCKS_PER_SM - reserved_per_block
    return (per_block - smem_bytes(c, groups, vec, 0)) // 16 * 16


def gn_plan(b: int, hw: int, c: int, itemsize: int, resident_blocks: int,
            slab_bytes: int, sms: int = 0) -> GnPlan:
    """Slabs and grid of one call on (b, hw, c) rows of ``itemsize``
    bytes, for a card that holds ``resident_blocks`` blocks at once, each
    with ``slab_bytes`` of slab, on ``sms`` SMs (0: no preference).

    Held where a block per slab fits: as many slabs an image as one block
    an SM allows where they hold the tensor (on an H100 the small serving
    sites ran faster so than on two blocks an SM: a cheaper barrier and
    fold), else as many as the resident grid allows.  Else streamed:
    slabs as large as half the capacity (the kernel keeps the next one's
    copy in flight in the other half), spread evenly over at most
    ``resident_blocks`` blocks."""
    row = c * itemsize
    cap_rows, stream_rows = slab_bytes // row, slab_bytes // 2 // 16 * 16 // row
    if stream_rows < 1 or resident_blocks < 1:
        raise ValueError(f"a slab of {slab_bytes} bytes holds no row of C={c} twice")
    for limit in sorted({min(sms or resident_blocks, resident_blocks), resident_blocks}):
        spi = max(1, limit // b)
        rows = -(-hw // spi)
        if b * spi <= limit and rows <= cap_rows:
            spi = -(-hw // rows)
            return GnPlan(b * spi, rows, spi, 1, True)
    spi = -(-hw // min(hw, stream_rows))
    rows = -(-hw // spi)
    spi = -(-hw // rows)
    total = b * spi
    per_block = -(-total // min(resident_blocks, total))
    grid = -(-total // per_block)
    return GnPlan(grid, rows, spi, per_block, grid >= total)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library, with argtypes set.
    Call before a worker thread first launches the kernel."""
    lib = build.load("group_norm_elu")
    fn = lib.gn_elu_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 11 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.gn_elu_device.argtypes = [p]
        lib.gn_elu_device.restype = ctypes.c_int
        lib.gn_elu_occupancy.argtypes = [i, i, i, i, p]
        lib.gn_elu_occupancy.restype = ctypes.c_int
        lib.gn_rows_unroll.restype = ctypes.c_int
        if lib.gn_rows_unroll() != ROWS_UNROLL:
            raise RuntimeError(f"the built split form unrolls {lib.gn_rows_unroll()} rows, "
                               f"rows_plan {ROWS_UNROLL}")
        lib.gn_rows_occupancy.argtypes = [i] * 6 + [p]
        lib.gn_rows_occupancy.restype = ctypes.c_int
        lib.gn_rows_sums.argtypes = [p] * 4 + [i] * 11 + [p]
        lib.gn_rows_sums.restype = ctypes.c_int
        lib.gn_rows_apply.argtypes = [p] * 6 + [i] * 9 + [ctypes.c_float] * 2 + [i, i, p]
        lib.gn_rows_apply.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _resident(device: int, dtype: int, vec: int, c: int, groups: int):
    """(SMs, resident blocks, slab bytes, dynamic shared memory) of the
    kernel for (dtype, vec, C, G) on the current device, queried once."""
    lib = load()
    info = (ctypes.c_int * 5)()
    err = lib.gn_elu_device(info)
    if err != 0:
        raise RuntimeError(f"gn_elu_device failed: cudaError {err}")
    sms, smem_sm, reserved, _, coop = info
    if not coop:
        raise RuntimeError("the card does not take cooperative launches")
    slab = slab_capacity(c, groups, vec, smem_sm, reserved)
    dyn = smem_bytes(c, groups, vec, slab)
    px, by = block_shape(c, vec)
    blocks = ctypes.c_int(0)
    err = lib.gn_elu_occupancy(dtype, vec, px * by, dyn, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(
            f"gn_elu_occupancy failed: cudaError {err}, {blocks.value} blocks an SM")
    return sms, sms * blocks.value, slab, dyn


def _vec(x: torch.Tensor) -> int:
    """Elements a thread loads at once from CUDA x (B, C, H, W): 16 bytes'
    worth where C and the pointer allow, else 1 (the scalar route)."""
    vec = 16 // x.element_size()
    return 1 if x.shape[1] % vec or x.data_ptr() % 16 else vec


def _config(x: torch.Tensor, groups: int):
    """(vec, plan, slab bytes, dynamic shared memory) of the kernel for
    CUDA x (B, C, H, W) in channels_last: 16-byte loads where C and the
    pointer allow, else the scalar route (vec 1)."""
    b, c, h, w = x.shape
    vec = _vec(x)
    sms, resident, slab, dyn = _resident(x.device.index or 0, _DTYPES[x.dtype], vec, c,
                                         groups)
    return vec, gn_plan(b, h * w, c, x.element_size(), resident, slab, sms), slab, dyn


def plan_for(x: torch.Tensor, groups: int) -> GnPlan:
    """The plan the kernel takes for CUDA x (B, C, H, W) in channels_last."""
    return _config(x, groups)[1]


def _check(x, scale, bias, groups):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got shape {tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"C={c} is not divisible by groups={groups}")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(
            f"scale/bias must be ({c},), got {tuple(scale.shape)}, "
            f"{tuple(bias.shape)}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32|bfloat16)")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must lie on one device")


def _launch(x, scale, bias, groups, eps):
    """Run the kernel on channels_last CUDA x -> (out, fp32 (B, 2, G)
    mean and inverse std)."""
    b, c, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (NHWC memory)")
    if c > _MAX_C:
        raise ValueError(f"C={c} exceeds the kernel's limit of {_MAX_C}")
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    vec, plan, slab, dyn = _config(x, groups)
    px, by = block_shape(c, vec)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    partials = torch.empty((b * plan.slabs_per_image, groups, 2), dtype=torch.float32,
                           device=x.device)
    err = load().gn_elu_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        partials.data_ptr(), stats.data_ptr(), b, h * w, c, groups, plan.rows,
        plan.slabs_per_image, plan.grid, px, by, slab, dyn, float(eps), _DTYPES[x.dtype], vec,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gn_elu_forward failed: cudaError {err}")
    group_norm_elu.launches += 1
    return out, stats


class _GroupNormELUKernel(torch.autograd.Function):
    """Kernel forward, analytic plain-PyTorch backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        out, stats = _launch(x, scale, bias, groups, eps)
        ctx.save_for_backward(x, stats, scale, bias)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, da):
        x, stats, scale, bias = ctx.saved_tensors
        dy, dscale, dbias = backward_from_stats(da, x, stats, scale, bias, ctx.groups)
        return dy, dscale, dbias, None, None


def backward_from_stats(da, x, stats, scale, bias, groups, ax=None, rows=None):
    """(dx, dscale, dbias) of GroupNorm+ELU from x and the kernel's fp32
    (B, 2, G) mean and inverse std, expanded per channel by one op.
    ``ax``: x holds this rank's rows of the image (``rows`` of them in
    all) on that spatial axis."""
    dt = x.dtype
    st = stats.repeat_interleave(x.shape[1] // groups, dim=2)  # (B, 2, C)
    mean_c, inv_c = st[:, 0], st[:, 1]
    yn = (x - mean_c.to(dt)[:, :, None, None]) * inv_c.to(dt)[:, :, None, None]
    dy, dscale, dbias = gn_elu_backward(da, yn, inv_c, scale, bias, groups, ax=ax, rows=rows)
    return dy, dscale.to(scale.dtype), dbias.to(bias.dtype)


ROWS_UNROLL = 4  # rows a thread loads at once in the split form (csrc's kRowsUnroll)


class RowsPlan(NamedTuple):
    grid: int  # blocks, at most what the card holds at once
    rows: int  # NHWC rows of one slab
    slabs_per_image: int
    slabs_per_block: int  # the most any block walks


def rows_plan(b: int, hw: int, c: int, vec: int, resident_blocks: int) -> RowsPlan:
    """Slabs and grid of the split form on a rank's (b, hw, c) rows, for a
    card that holds ``resident_blocks`` of its blocks at once: slabs of
    one unrolled trip (``ROWS_UNROLL`` rows a thread row of the block:
    each thread issues all its loads at once, and a small site takes a
    few blocks), or, where the resident grid has fewer blocks for the
    batch, as many slabs an image as it has; a block walks slabs
    blockIdx, + grid, ..."""
    if resident_blocks < 1:
        raise ValueError("the card holds no block of the split form")
    trip = ROWS_UNROLL * block_shape(c, vec)[1]
    spi = max(1, min(resident_blocks // b, -(-hw // trip)))
    rows = -(-hw // spi)
    spi = -(-hw // rows)
    total = b * spi
    grid = min(total, resident_blocks)
    return RowsPlan(grid, rows, spi, -(-total // grid))


@functools.lru_cache(maxsize=None)
def _rows_resident(device: int, dtype: int, vec: int, c: int, groups: int) -> int:
    """Blocks of the split form's two kernels the current device holds at
    once for (dtype, vec, C, G), queried once."""
    lib = load()
    info = (ctypes.c_int * 5)()
    err = lib.gn_elu_device(info)
    if err != 0:
        raise RuntimeError(f"gn_elu_device failed: cudaError {err}")
    px, by = block_shape(c, vec)
    blocks = ctypes.c_int(0)
    err = lib.gn_rows_occupancy(dtype, vec, px, by, c, groups, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(
            f"gn_rows_occupancy failed: cudaError {err}, {blocks.value} blocks an SM")
    return info[0] * blocks.value


_COUNTERS = {}  # (device, stream) -> the per-image tickets of gn_rows_sums, left at 0


def _counters(device: torch.device, stream: int, b: int) -> torch.Tensor:
    """B zeroed int32 counters for a launch on ``stream``: each stream has
    its own, so that launches on two streams cannot share a ticket."""
    key = (device.index, stream)
    t = _COUNTERS.get(key)
    if t is None or t.numel() < b:
        t = _COUNTERS[key] = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
    return t


def rows_plan_for(x: torch.Tensor, groups: int) -> RowsPlan:
    """The plan the split form takes for this rank's CUDA rows x (B, C,
    h, W) in channels_last."""
    b, c, h, w = x.shape
    vec = _vec(x)
    return rows_plan(b, h * w, c, vec, _rows_resident(x.device.index or 0, _DTYPES[x.dtype],
                                                      vec, c, groups))


def _launch_rows(x, scale, bias, groups, eps, ax, rows):
    """The split form's two launches around the all-reduce over ``ax`` ->
    (out, fp32 (B, 2, G) mean and inverse std of the whole image of
    ``rows`` rows).  A rank without rows launches neither kernel and
    takes the statistics from the all-reduced sums."""
    b, c, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (NHWC memory)")
    if c > _MAX_C:
        raise ValueError(f"C={c} exceeds the kernel's limit of {_MAX_C}")
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    n = float(rows * w * (c // groups))
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if not h:  # no rows here: zero sums into the all-reduce, the statistics alone
        sums = torch.zeros((b, groups, 2), dtype=torch.float32, device=x.device)
        if ax.size > 1:
            dist.all_reduce(sums, group=ax.group)
        mean = sums[..., 0] / n
        inv = torch.rsqrt(torch.clamp(sums[..., 1] / n - mean.square(), min=0.0) + eps)
        return out, torch.stack([mean, inv], 1)
    vec = _vec(x)
    px, by = block_shape(c, vec)
    plan = rows_plan_for(x, groups)
    spi = plan.slabs_per_image
    lib = load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partials = torch.empty((b * spi, groups, 2), dtype=torch.float32, device=x.device)
    # each image's slabs folded to (B, G, 2) by the kernel: one shape on
    # every rank, whatever its rows, summed over the ranks and read by apply
    sums = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    err = lib.gn_rows_sums(x.data_ptr(), partials.data_ptr(), sums.data_ptr(),
                           _counters(x.device, stream, b).data_ptr(), b, h * w, c, groups,
                           plan.rows, spi, plan.grid, px, by, _DTYPES[x.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"gn_rows_sums failed: cudaError {err}")
    if ax.size > 1:
        dist.all_reduce(sums, group=ax.group)
    stats = torch.empty((b, 2, groups), dtype=torch.float32, device=x.device)
    err = lib.gn_rows_apply(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), sums.data_ptr(),
                            out.data_ptr(), stats.data_ptr(), b, h * w, c, groups, plan.rows,
                            spi, plan.grid, px, by, n, float(eps), _DTYPES[x.dtype], vec,
                            stream)
    if err != 0:
        raise RuntimeError(f"gn_rows_apply failed: cudaError {err}")
    group_norm_elu_rows.launches += 1
    return out, stats


def _rows_plain(x, scale, bias, groups, eps, ax, rows):
    """The split form in plain PyTorch: the sums all-reduced over ``ax``,
    then ``group_norm_elu_analytic``'s forward with the whole image's
    statistics (mean and inverse rounded to x's dtype)."""
    b, c, h, w = x.shape
    xf = x.float()
    sums = torch.stack([xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3))], 1)  # (B, 2, C)
    if ax.size > 1:
        dist.all_reduce(sums, group=ax.group)
    sums = sums.view(b, 2, groups, -1).sum(-1)
    n = rows * w * (c // groups)
    mean = sums[:, 0] / n
    inv = torch.rsqrt(torch.clamp(sums[:, 1] / n - mean.square(), min=0.0) + eps)
    stats = torch.stack([mean, inv], 1)
    dt = x.dtype
    st = stats.repeat_interleave(c // groups, dim=2)
    yn = (x - st[:, 0].to(dt)[:, :, None, None]) * st[:, 1].to(dt)[:, :, None, None]
    z = yn * scale.to(dt)[:, None, None] + bias.to(dt)[:, None, None]
    return torch.nn.functional.elu(z).contiguous(memory_format=torch.channels_last), stats


class _GroupNormELURows(torch.autograd.Function):
    """The split form: the kernel's forward on the card, the plain one on
    the CPU; the analytic backward with its reductions all-reduced."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, ax, rows):
        fwd = _launch_rows if x.device.type == "cuda" else _rows_plain
        out, stats = fwd(x, scale, bias, groups, eps, ax, rows)
        ctx.save_for_backward(x, stats, scale, bias)
        ctx.groups, ctx.ax, ctx.rows = groups, ax, rows
        return out

    @staticmethod
    def backward(ctx, da):
        x, stats, scale, bias = ctx.saved_tensors
        dy, dscale, dbias = backward_from_stats(da, x, stats, scale, bias, ctx.groups, ctx.ax,
                                                ctx.rows)
        return dy, dscale, dbias, None, None, None, None


def group_norm_elu_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        groups: int, eps: float, ax, rows: Optional[int] = None
                        ) -> torch.Tensor:
    """GroupNorm + ELU of the whole image on this rank's rows x (B, C, h,
    W) of it, over the spatial axis ``ax`` (``parallel.mesh.Axis``; of
    extent 1, the whole image: no collective): the split form.  The
    image has ``rows`` rows in all (None: h x the extent, an even
    split); a rank may hold any number of them, none included, and the
    statistics divide by the whole image's count.  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernels or raises."""
    _check(x, scale, bias, groups)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    rows = x.shape[2] * ax.size if rows is None else rows
    return _GroupNormELURows.apply(x, scale, bias, groups, eps, ax, rows)


group_norm_elu_rows.launches = 0


def group_norm_elu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm + ELU of x (B, C, H, W), channels_last memory.

    scale, bias: (C,).  Returns x's shape and dtype in channels_last
    memory, differentiable in x, scale and bias.  A CPU tensor runs the plain
    analytic form; a CUDA tensor launches the kernel or raises."""
    _check(x, scale, bias, groups)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad):
        if x.device.type == "cpu":
            return group_norm_elu_analytic(x, scale, bias, groups, eps)
        return _GroupNormELUKernel.apply(x, scale, bias, groups, eps)
    return ops.group_norm_elu(x, scale, bias, groups, eps)


group_norm_elu.launches = 0
