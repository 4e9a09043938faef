"""Tensor parallelism (the ``"model"`` mesh dim): column parallelism in
the Megatron form, written out where the JAX package has XLA's SPMD
partitioner insert the collectives.

Each model rank holds the slice of every sharded parameter's output
channels (``parallel.mesh.shard_columns``).  A conv site takes the whole
input, runs its conv on the weight slice and its GroupNorm epilogue on
that slice of channels, and the slices are gathered into the whole
output, which every model rank then holds alike:

- ``copy_to_model``: the identity forward; the backward sums the input
  gradient over ``"model"`` (each rank's conv saw only its output
  channels, so its input gradient is a part);
- ``gather_from_model``: the channel slices all-gathered in the forward;
  the backward takes this rank's slice of the gradient and does not sum
  it, since everything after the gather runs alike on every model rank
  (a backward that reduce-scattered would scale every gradient by M).

The GroupNorm epilogue runs on the slice only where M divides the group
count, so that each group lies whole on one rank (``local_groups``);
otherwise the site gathers first (``column_site``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from gdn_tpu_torch.parallel.mesh import Axis

CL = torch.channels_last


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.ax.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        part = x.contiguous()
        parts = [torch.empty_like(part) for _ in range(ax.size)]
        dist.all_gather(parts, part, group=ax.group)
        out = torch.cat(parts, dim=dim)
        return out.contiguous(memory_format=CL) if out.dim() == 4 else out

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.ax.size, ctx.dim)[ctx.ax.rank], None, None


def copy_to_model(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """x as it is; its gradient summed over the model ranks."""
    return _CopyToModel.apply(x, ax)


def gather_from_model(x: torch.Tensor, ax: Axis, dim: int = 1) -> torch.Tensor:
    """The model ranks' slices of x concatenated on ``dim`` (channels:
    dim 1 of an activation, dim 0 of a parameter); the gradient is this
    rank's slice of the whole one."""
    return _GatherFromModel.apply(x, ax, dim)


def local_groups(groups: int, ax: Axis) -> Optional[int]:
    """The groups of one channel slice, or None where M does not divide
    the group count (a group would straddle two ranks)."""
    return groups // ax.size if groups % ax.size == 0 else None


def column_site(ax: Axis, conv: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                epilogue: Callable, xs: Sequence[torch.Tensor], scale: torch.Tensor,
                bias: torch.Tensor, groups: int) -> torch.Tensor:
    """One column-parallel conv + GroupNorm site: ``conv(xs)`` runs on
    the whole inputs and this rank's weight slice, ``epilogue(y, scale,
    bias, groups)`` on its channels; the output is gathered whole.
    Where the slice would split a group, the conv output and the affine
    parameters are gathered first and the epilogue runs whole."""
    y = conv([copy_to_model(x, ax) for x in xs])
    g = local_groups(groups, ax)
    if g is not None:
        return gather_from_model(epilogue(y, scale, bias, g), ax)
    y = gather_from_model(y, ax)
    return epilogue(y, gather_from_model(scale, ax, 0), gather_from_model(bias, ax, 0),
                    groups)


def column_fused(ax: Axis, call: Callable, xs: Sequence[torch.Tensor],
                 ws: Sequence[torch.Tensor], scale: torch.Tensor, bias: torch.Tensor,
                 groups: int) -> torch.Tensor:
    """A fused conv+GroupNorm+ELU kernel as a column-parallel site:
    ``call(xs, ws, scale, bias, groups)`` on this rank's weight slice and
    groups, the output gathered.  Where the slice would split a group,
    the weights are gathered and the kernel runs whole on every rank."""
    g = local_groups(groups, ax)
    if g is not None:
        return gather_from_model(call([copy_to_model(x, ax) for x in xs], ws, scale, bias, g),
                                 ax)
    whole = [gather_from_model(w, ax, 0) for w in (*ws, scale, bias)]
    return call(xs, whole[:len(ws)], whole[-2], whole[-1], groups)


def _gather_pair(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The whole [D | G] tensor from the ranks' [D_r | G_r] halves: each
    net's slices gathered apart, then joined."""
    c = t.shape[dim] // 2
    return torch.cat([gather_from_model(t.narrow(dim, 0, c), ax, dim),
                      gather_from_model(t.narrow(dim, c, c), ax, dim)], dim)


def paired_site(ax: Axis, conv: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                epilogue: Callable, x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, groups: int) -> torch.Tensor:
    """One site of the paired encoder ladder (``train.fused_encoders``)
    as a column-parallel site: each rank holds its slice of both nets'
    output channels, so the grouped conv gives [D_r | G_r] where the
    whole output is [D | G], and ``scale``/``bias`` are [D_r | G_r] too.
    The epilogue's ``groups`` (2G) run on the slice where M divides G
    (each group on one rank, in the slice's order); the gather puts each
    net's slices back in order.  Otherwise the conv output and the
    affine parameters are gathered so first and the epilogue runs
    whole."""
    y = conv([copy_to_model(x, ax)])
    g = local_groups(groups // 2, ax)
    if g is not None:
        return _gather_pair(epilogue(y, scale, bias, 2 * g), ax, 1)
    return epilogue(_gather_pair(y, ax, 1), _gather_pair(scale, ax, 0),
                    _gather_pair(bias, ax, 0), groups)
