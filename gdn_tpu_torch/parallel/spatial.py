"""Spatial parallelism (the ``"spatial"`` mesh dim): each rank holds its
rows of the image height of every activation, written out where the JAX
package has XLA's SPMD partitioner insert halo exchanges and psums.

The layout: a level of ``h`` global rows is ``torch.tensor_split`` over
the extent (``row_sizes``: the first ``h % S`` ranks hold one row more).
The JAX package asks only that the extent divide the input height
(``parallel.mesh.check_rows``), so the input's shards are even and a
stride-2 level of an odd height (NYU's 228 -> 114 -> 57 -> 29 -> 15 ->
8) is not.  A rank does not see the global height in its shard, so
every row op takes it (``rows``); the blocks carry it down from the
encoder's input.

Each op runs on the rank's rows where the layouts line up, and on the
whole image otherwise (gathered around the op and split again, as XLA
gathers around a custom call):

- ``halo``: the neighbours' rows above and below, one
  ``autograd.Function``: the forward all-gathers each rank's edge rows,
  the backward sends the halo rows' gradients back to their owners,
  which add them.  At the global top and bottom the rows are padded as
  the op pads its edge: zeros (a conv's SAME pad), the edge row (the
  bilinear resize's clamp), reflect-101 (SSIM's window) or nothing (a
  forward difference).
- ``conv_rows``: an XLA "SAME" conv (``conv_plan``).  Local where every
  output shard's first row reads from its rank's first input row (at
  stride 2: every shard starts on an even global row) and every shard
  holds the halo: t rows from above and max(k - s - t, b) from below
  for SAME pads (t, b), 1 and 1 for 3x3, 3 and 3 for the 7x7 stem, 0
  and 1 (even height) or 1 and 1 (odd) for the stride-2 3x3.
- ``resize_rows``: the bilinear resize.  Local (one row each side,
  clamped at the global edges) at an exact 2x whose output shards are
  twice the input's; any other size gathers.
- ``conv_transpose_rows``: the deconv branch's stride-2 transposed conv
  at an exact 2x target with aligned shards: input rows [a, b) give
  output rows [2a, 2b) from rows [a - 1, b + 1), zeros at the global
  edges; otherwise (and before a resize to the skip's size) gathered.
- ``gather_rows`` / ``split_rows``: the whole image around an op with no
  row form; the gather's backward sums the ranks' partial gradients, the
  split's zero-fills the rows of the other ranks.  ``gather_rows.calls``
  counts the gathers.
- ``sum_over``: a differentiable sum over the dim (the non-ELU
  GroupNorm's statistics); the GroupNorm+ELU statistics are summed
  inside the kernel wrapper (``kernels.groupnorm.group_norm_elu_rows``),
  the loss's in ``losses`` (``rows=``).  Counts are the whole image's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gdn_tpu_torch.ops.conv import CL, conv_same, same_pads
from gdn_tpu_torch.ops.resize import resize_bilinear
from gdn_tpu_torch.parallel.mesh import Axis

_MODES = ("zeros", "edge", "reflect", "none")


# ----------------------------------------------------------------- layout

def row_sizes(h: int, n: int) -> List[int]:
    """The shard sizes of ``h`` rows over ``n`` ranks
    (``torch.tensor_split``: the first ``h % n`` hold one more)."""
    q, rem = divmod(h, n)
    return [q + (r < rem) for r in range(n)]


def row_starts(h: int, n: int) -> List[int]:
    sizes = row_sizes(h, n)
    return [sum(sizes[:r]) for r in range(n)]


def row_bounds(h: int, ax: Axis) -> Tuple[int, int]:
    """[start, stop) of this rank's rows of ``h``."""
    s = row_starts(h, ax.size)[ax.rank]
    return s, s + row_sizes(h, ax.size)[ax.rank]


def level_rows(h: int, levels: int) -> List[int]:
    """The heights of ``levels`` stride-2 SAME stages from ``h``: h,
    ceil(h / 2), ... (``levels + 1`` of them)."""
    out = [h]
    for _ in range(levels):
        out.append(-(-out[-1] // 2))
    return out


def rows_of(x: torch.Tensor, ax: Axis, rows: Optional[int], dim: int = 2) -> int:
    """The global height of x: ``rows`` where given, else that of an even
    split (the input's)."""
    return x.shape[dim] * ax.size if rows is None else rows


# ------------------------------------------------------------ collectives

def _all_gather(t: torch.Tensor, ax: Axis):
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    dist.all_gather(parts, t, group=ax.group)
    return parts


class _Halo(torch.autograd.Function):
    """x with ``top`` rows of the rank above and ``bottom`` rows of the
    rank below (none where there is no such rank)."""

    @staticmethod
    def forward(ctx, x, ax, top, bottom, dim):
        h = x.shape[dim]
        ctx.ax, ctx.top, ctx.bottom, ctx.dim, ctx.h = ax, top, bottom, dim, h
        parts = _all_gather(torch.cat([x.narrow(dim, 0, bottom), x.narrow(dim, h - top, top)],
                                      dim), ax)
        pieces = [x]
        if ax.rank > 0:
            pieces.insert(0, parts[ax.rank - 1].narrow(dim, bottom, top))
        if ax.rank < ax.size - 1:
            pieces.append(parts[ax.rank + 1].narrow(dim, 0, bottom))
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, g):
        ax, top, bottom, dim, h = ctx.ax, ctx.top, ctx.bottom, ctx.dim, ctx.h
        t = top if ax.rank > 0 else 0
        b = bottom if ax.rank < ax.size - 1 else 0

        def rows(start, n, want):
            if n:
                return g.narrow(dim, start, n)
            shape = list(g.shape)
            shape[dim] = want
            return g.new_zeros(shape)

        # to the rank above: the gradient of its last `top` rows; below:
        # of its first `bottom` rows
        parts = _all_gather(torch.cat([rows(0, t, top), rows(t + h, b, bottom)], dim), ax)
        gx = g.narrow(dim, t, h).clone()
        if ax.rank < ax.size - 1 and top:
            gx.narrow(dim, h - top, top).add_(parts[ax.rank + 1].narrow(dim, 0, top))
        if ax.rank > 0 and bottom:
            gx.narrow(dim, 0, bottom).add_(parts[ax.rank - 1].narrow(dim, top, bottom))
        return gx, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, ax: Axis, mode: str = "zeros",
         dim: int = 2) -> torch.Tensor:
    """x (its rows on ``dim``) with ``top`` rows above and ``bottom``
    below: the neighbours' where there are, else the global edge padded
    by ``mode`` ("none": left off).  Every rank's shard must hold the
    halo (reflect: one row more)."""
    if mode not in _MODES:
        raise ValueError(f"unknown halo mode {mode!r} {_MODES}")
    h = x.shape[dim]
    if max(top, bottom) > h or (mode == "reflect" and max(top, bottom) >= h):
        raise ValueError(f"a halo of {max(top, bottom)} rows from a shard of {h} rows: "
                         "the op must run on the gathered rows")
    ext = _Halo.apply(x, ax, top, bottom, dim)
    if mode == "none":
        return ext
    pieces = [ext]
    if ax.rank == 0 and top:
        pieces.insert(0, _edge(x, top, dim, mode, first=True))
    if ax.rank == ax.size - 1 and bottom:
        pieces.append(_edge(x, bottom, dim, mode, first=False))
    return torch.cat(pieces, dim) if len(pieces) > 1 else ext


def _edge(x: torch.Tensor, n: int, dim: int, mode: str, first: bool) -> torch.Tensor:
    h = x.shape[dim]
    if mode == "zeros":
        shape = list(x.shape)
        shape[dim] = n
        return x.new_zeros(shape)
    if mode == "edge":
        row = x.narrow(dim, 0 if first else h - 1, 1)
        return torch.cat([row] * n, dim)
    # reflect-101: row -j is row j, row h-1+j is row h-1-j
    rows = x.narrow(dim, 1, n) if first else x.narrow(dim, h - 1 - n, n)
    return rows.flip(dim)


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=CL) if t.dim() == 4 else t.contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, h):
        sizes = row_sizes(h, ax.size)
        ctx.ax, ctx.dim, ctx.h = ax, dim, h
        if x.shape[dim] != sizes[ax.rank]:
            raise ValueError(f"a shard of {x.shape[dim]} rows where the layout of {h} rows "
                             f"gives {sizes[ax.rank]}")
        pad = max(sizes) - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim)
        parts = _all_gather(x, ax)
        return _cl(torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.ax.group)
        s, e = row_bounds(ctx.h, ctx.ax)
        return _cl(g.narrow(ctx.dim, s, e - s)), None, None, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.shape = ax, dim, x.shape
        s, e = row_bounds(x.shape[dim], ax)
        return _cl(x.narrow(dim, s, e - s))

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        s, e = row_bounds(ctx.shape[ctx.dim], ctx.ax)
        full.narrow(ctx.dim, s, e - s).copy_(g)
        return _cl(full), None, None


def gather_rows(x: torch.Tensor, ax: Axis, rows: Optional[int] = None,
                dim: int = 2) -> torch.Tensor:
    """The whole image (``rows`` global rows; None: an even split) from
    the ranks' rows; the gradient of this rank's rows is the sum of the
    ranks' gradients of them."""
    gather_rows.calls += 1
    return _GatherRows.apply(x, ax, dim, rows_of(x, ax, rows, dim))


gather_rows.calls = 0


def split_rows(x: torch.Tensor, ax: Axis, dim: int = 2) -> torch.Tensor:
    """This rank's rows of a whole image; the others' rows get no
    gradient here."""
    return _SplitRows.apply(x, ax, dim)


def global_rows(x: torch.Tensor, ax: Axis, dim: int = 2) -> int:
    """The global height of a sharded x whose height the caller does not
    know (the coarse heads' maps in the loss): the ranks' sizes summed,
    one small all-gather read on the host."""
    n = torch.tensor([x.shape[dim]], dtype=torch.int64, device=x.device)
    return int(sum(int(p.item()) for p in _all_gather(n, ax)))


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        out = t.contiguous().clone()
        dist.all_reduce(out, group=ax.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.ax.group)
        return g, None


def sum_over(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """t summed over the ranks of ``ax``, differentiable: every rank's
    result feeds its own loss, so the gradient is summed back."""
    return _SumOver.apply(t, ax) if ax.size > 1 else t


# ----------------------------------------------------------------- the ops

def conv_plan(h: int, k: int, stride: int, n: int) -> Optional[Tuple[int, int]]:
    """(top, bottom) halo rows of a k-tap SAME conv at ``stride`` of ``h``
    rows over ``n`` ranks run on each rank's rows, or None where it runs
    gathered: an output shard that does not start at stride x its input
    shard's start, an empty one, or a shard thinner than the halo."""
    out = -(-h // stride)
    t, b = same_pads(h, k, stride)
    ins, outs = row_sizes(h, n), row_sizes(out, n)
    if min(outs) < 1 or any(si != so * stride for si, so in zip(row_starts(h, n),
                                                               row_starts(out, n))):
        return None
    top, bottom = t, max(k - stride - t, b)
    if min(ins) < max(top, bottom):
        return None
    return top, bottom


def conv_rows(x: torch.Tensor, kernel: torch.Tensor, stride: int, ax: Axis,
              rows: Optional[int] = None, bias=None, groups: int = 1) -> torch.Tensor:
    """``ops.conv.conv_same(x, kernel, stride, bias, groups)`` of the
    whole image of ``rows`` global rows, on this rank's rows of x (B, C,
    h, W) -> its rows of the output (``conv_plan``)."""
    k, h = kernel.shape[2], rows_of(x, ax, rows)
    plan = conv_plan(h, k, stride, ax.size)
    if plan is None:
        return split_rows(conv_same(gather_rows(x, ax, h), kernel, stride, bias, groups), ax)
    top, bottom = plan
    o_s, o_e = row_bounds(-(-h // stride), ax)
    ext = halo(x, top, bottom, ax, "zeros").narrow(2, 0, (o_e - o_s - 1) * stride + k)
    l, r = same_pads(x.shape[3], kernel.shape[3], stride)
    kernel = kernel.contiguous(memory_format=CL)
    if l == r:
        return F.conv2d(ext, kernel, bias, stride, padding=(0, l), groups=groups)
    return F.conv2d(F.pad(ext, (l, r, 0, 0)), kernel, bias, stride, groups=groups)


def doubles(h: int, n: int) -> bool:
    """Whether the layout of 2h rows is twice that of h (an exact 2x runs
    on each rank's rows)."""
    return min(row_sizes(h, n)) >= 1 and row_sizes(2 * h, n) == [2 * s for s in
                                                                  row_sizes(h, n)]


def resize_plan(h: int, target: int, n: int) -> bool:
    """Whether the bilinear resize of ``h`` rows to ``target`` runs on
    each rank's rows (True) or gathered."""
    return target == 2 * h and doubles(h, n)


def upsample2x_rows(x: torch.Tensor, width: int, ax: Axis) -> torch.Tensor:
    """The bilinear resize of the whole image to twice its height (and
    ``width`` columns), in x's dtype, on this rank's rows: one row of
    each neighbour, the edge row at the global top and bottom."""
    h = x.shape[2]
    ext = halo(x, 1, 1, ax, "edge")
    return resize_bilinear(ext, (2 * h + 4, width), precise=False)[:, :, 2:2 * h + 2]


def resize_rows(x: torch.Tensor, size: Tuple[int, int], ax: Axis, rows: Optional[int] = None,
                precise: bool = True) -> torch.Tensor:
    """``resize_bilinear`` of the whole image of ``rows`` global rows to
    ``size`` (global), on this rank's rows (``resize_plan``)."""
    h = rows_of(x, ax, rows)
    if resize_plan(h, size[0], ax.size):
        out = upsample2x_rows(x.float() if precise else x, size[1], ax)
        return out.to(x.dtype)
    return split_rows(resize_bilinear(gather_rows(x, ax, h), size, precise), ax)


def conv_transpose_rows(x: torch.Tensor, weight: torch.Tensor, bias, padding: int,
                        size: Tuple[int, int], ax: Axis,
                        rows: Optional[int] = None) -> torch.Tensor:
    """The deconv branch's ``F.conv_transpose2d(x, weight, bias, stride=2,
    padding)`` (output 2h x 2W) of the whole image, resized to ``size``
    where that differs, on this rank's rows.  Local at an exact 2x with
    aligned shards: output rows [2a, 2b) read input rows [a - 1, b + 1)
    (zeros beyond the image); otherwise the input is gathered."""
    h = rows_of(x, ax, rows)
    if not resize_plan(h, size[0], ax.size) or 2 * x.shape[3] != size[1]:
        y = F.conv_transpose2d(gather_rows(x, ax, h), weight, bias, stride=2, padding=padding)
        if tuple(y.shape[2:]) != tuple(size):
            y = resize_bilinear(y, size)
        return split_rows(y, ax)
    n = x.shape[2]
    ext = halo(x, 1, 1, ax, "zeros")
    y = F.conv_transpose2d(ext, weight, bias, stride=2, padding=padding)
    return y.narrow(2, 2, 2 * n)


def site_plan(image_rows: int, levels: int, n: int,
              upsample: str = "resize_conv") -> List[Tuple[str, bool]]:
    """(site, runs on each rank's rows) of one net's row ops at an input
    height over ``n`` ranks, in forward order: the stem, each
    DownBlock's two convs, each decoder scale's upsample (resize or
    deconv) and its 3x3 convs (the heads' too), as ``conv_plan`` and
    ``resize_plan`` decide them; the gathers a step makes are counted by
    ``gather_rows.calls``."""
    hs = level_rows(image_rows, levels)
    out = [("stem 7x7", conv_plan(hs[0], 7, 1, n) is not None)]
    for i in range(levels):
        out.append((f"down{i} 3x3/2 {hs[i]}->{hs[i + 1]}",
                    conv_plan(hs[i], 3, 2, n) is not None))
        out.append((f"down{i} 3x3 {hs[i + 1]}", conv_plan(hs[i + 1], 3, 1, n) is not None))
    for i in range(levels):
        src, dst = hs[levels - i], hs[levels - 1 - i]
        op = "deconv" if upsample == "deconv" else "resize"
        out.append((f"up{i} {op} {src}->{dst}", resize_plan(src, dst, n)))
        out.append((f"up{i} 3x3 {dst}", conv_plan(dst, 3, 1, n) is not None))
    return out


def ssim_local(h: int, window: int, n: int) -> bool:
    """Whether SSIM's window runs on each rank's rows: every shard holds
    one row more than the half window (reflect-101 at the edges)."""
    return min(row_sizes(h, n)) > window // 2


def pools_local(h: int, scales: int, n: int) -> bool:
    """Whether the gradient loss's ``scales - 1`` 2x2 pools run on each
    rank's rows: every shard divides by 2^(scales - 1)."""
    return all(s % 2 ** (scales - 1) == 0 and s > 0 for s in row_sizes(h, n))

