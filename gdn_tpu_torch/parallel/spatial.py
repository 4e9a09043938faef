"""Spatial parallelism (the ``"spatial"`` mesh dim): each rank holds its
rows of the image height of every activation, written out where the JAX
package has XLA's SPMD partitioner insert halo exchanges and psums.

Every shard holds the same number of rows (``parallel.mesh.height_rows``
splits the batch evenly, and ``check_rows`` refuses a net whose levels
would not split so), so the global height is the local one times the
extent, and every stride-2 shard starts on an even row.

- ``halo``: the neighbours' rows above and below, one
  ``autograd.Function``: the forward all-gathers each rank's edge rows,
  the backward sends the halo rows' gradients back to their owners,
  which add them.  At the global top and bottom the rows are padded as
  the op pads its edge: zeros (a conv's SAME pad), the edge row (the
  bilinear resize's clamp), reflect-101 (SSIM's window) or nothing (a
  forward difference).
- ``conv_rows``: an XLA "SAME" conv of sharded rows.  A k-tap conv at
  stride s with SAME pads (t, b) on the global height takes t rows from
  above and k - s - t from below: 1 and 1 for 3x3, 3 and 3 for the 7x7
  stem, 0 and 1 for the stride-2 3x3 (XLA pads even heights (0, 1)).
- ``upsample2x_rows``: the exact-2x bilinear upsample with one row each
  side, clamped at the global edges only.
- ``gather_rows`` / ``split_rows``: the whole image around an op with no
  halo form (the fused conv kernels), as XLA gathers around a custom
  call; the gather's backward sums the ranks' partial gradients, the
  split's zero-fills the rows of the other ranks.
- The GroupNorm statistics are summed over the dim inside the kernel
  wrapper (``kernels.groupnorm.group_norm_elu_rows``), the loss's in
  ``losses`` (``rows=``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gdn_tpu_torch.ops.conv import CL, same_pads
from gdn_tpu_torch.ops.resize import resize_bilinear
from gdn_tpu_torch.parallel.mesh import Axis

_MODES = ("zeros", "edge", "reflect", "none")


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
    by ``mode`` ("none": left off)."""
    if mode not in _MODES:
        raise ValueError(f"unknown halo mode {mode!r} {_MODES}")
    h = x.shape[dim]
    if max(top, bottom) > h or (mode == "reflect" and max(top, bottom) >= h):
        raise ValueError(f"a halo of {max(top, bottom)} rows from a shard of {h} rows: "
                         "the spatial extent is too large for this height")
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


def conv_rows(x: torch.Tensor, kernel: torch.Tensor, stride: int, ax: Axis,
              bias=None) -> torch.Tensor:
    """``ops.conv.conv_same(x, kernel, stride, bias)`` of the whole
    image, on this rank's rows of x (B, C, h, W) -> its rows of the
    output."""
    k, h = kernel.shape[2], x.shape[2]
    if h % stride:
        raise ValueError(f"a shard of {h} rows at stride {stride}: the shards would not "
                         "start on the stride")
    t, _ = same_pads(h * ax.size, k, stride)
    ext = halo(x, t, k - stride - t, ax, "zeros")
    l, r = same_pads(x.shape[3], kernel.shape[3], stride)
    kernel = kernel.contiguous(memory_format=CL)
    if l == r:
        return F.conv2d(ext, kernel, bias, stride, padding=(0, l))
    return F.conv2d(F.pad(ext, (l, r, 0, 0)), kernel, bias, stride)


def upsample2x_rows(x: torch.Tensor, width: int, ax: Axis) -> torch.Tensor:
    """The bilinear resize of the whole image to twice its height (and
    ``width`` columns), in x's dtype, on this rank's rows: one row of
    each neighbour, the edge row at the global top and bottom."""
    h = x.shape[2]
    ext = halo(x, 1, 1, ax, "edge")
    return resize_bilinear(ext, (2 * h + 4, width), precise=False)[:, :, 2:2 * h + 2]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        out = torch.cat(_all_gather(x, ax), dim)
        return out.contiguous(memory_format=CL) if out.dim() == 4 else out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.ax.group)
        return g.chunk(ctx.ax.size, ctx.dim)[ctx.ax.rank], None, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.shape = ax, dim, x.shape
        out = x.chunk(ax.size, dim)[ax.rank]
        return out.contiguous(memory_format=CL) if out.dim() == 4 else out.contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.chunk(ctx.ax.size, ctx.dim)[ctx.ax.rank].copy_(g)
        return full, None, None


def gather_rows(x: torch.Tensor, ax: Axis, dim: int = 2) -> torch.Tensor:
    """The whole image from the ranks' rows; the gradient of this rank's
    rows is the sum of the ranks' gradients of them."""
    return _GatherRows.apply(x, ax, dim)


def split_rows(x: torch.Tensor, ax: Axis, dim: int = 2) -> torch.Tensor:
    """This rank's rows of a whole image; the others' rows get no
    gradient here."""
    return _SplitRows.apply(x, ax, dim)


def check_rows(height: int, levels: int, ax: Axis, min_rows: int = 6) -> None:
    """Refuse a height that the net's ``levels`` stride-2 stages would
    not split evenly over the extent (every shard an even number of
    rows at each stride-2 input), or whose shards are too thin for the
    largest halo (SSIM's 5 rows reflected at the edge: 6 rows)."""
    unit = ax.size * 2 ** levels
    if height % unit or height // ax.size < min_rows:
        raise NotImplementedError(
            f"spatial={ax.size} at height {height}: each level's rows must split evenly "
            f"(height a multiple of {unit}) into shards of at least {min_rows} rows; "
            "other heights are not ported to gdn_tpu_torch yet, see ROADMAP.md Queue A "
            "item 10c")
