"""Device mesh, batch rows and parameter placement (port of
``gdn_tpu/parallel/mesh.py``).

The JAX package gets its parallel modes from sharding annotations that
XLA's SPMD partitioner turns into collectives.  PyTorch has no
partitioner, so the port runs one process a rank (``multihost``) and
writes each mode out:

- **data parallel**: every rank holds the whole state, takes its rows of
  the global batch (``shard_batch``), and the gradients are summed over
  the ``"data"`` dim with one all-reduce (``train.state``).  Loss terms
  normalized by counts take their denominators over the global batch
  (``global_sum``): each rank's loss is its share of the global loss.
- **FSDP**: ``fully_shard`` (FSDP2) on each encoder and decoder block and
  on the root, each parameter sharded on the dim ``fsdp_spec`` picks;
  the Adam moments, the EMA and the accumulator follow their parameter.
  A parameter the rule leaves whole is kept out of FSDP (replicated,
  its gradient all-reduced like data parallel's).  On a (data x
  spatial) mesh the JAX package shards over ``"data"`` and replicates
  over ``"spatial"``: FSDP2's HSDP on the mesh laid out (spatial, data)
  (it replicates on the first dim and shards on the second), the
  gradients summed over both.  Code that reads a unit's weights outside
  its forward (stage 2's fused guidance) reads them through
  ``in_forward``.
- **TP** (a ``"model"`` dim): column parallelism.  Each model rank
  holds the slice of every parameter's output channels that
  ``tensor_parallel_spec`` shards (``shard_columns``) and of its Adam
  moments and EMA; each conv site runs on the whole input and its own
  output channels, and the channels are gathered after the GroupNorm
  epilogue (``parallel.tensor``).
- **SP** (a ``"spatial"`` dim): each rank holds its image rows of every
  activation (``shard_batch`` splits height, as ``batch_sharding``
  does); convolutions, the upsample and SSIM meet their neighbours'
  rows by halo exchange and the GroupNorm and loss statistics are
  summed over the dim (``parallel.spatial``).
- The dims compose: ``create_mesh(spatial=, model=)`` lays out
  ``(data, spatial, model)``.  Pixel sums (loss counts, the reported
  terms, the parameter gradients) run over ``pixel_group``, the
  ``"data"`` x ``"spatial"`` ranks; the ``"model"`` ranks compute the
  same loss.

``replicated`` and ``batch_sharding`` have no counterpart object: a
replicated tensor is a plain tensor on every rank, and a sharded batch
is each rank's rows (``local_rows``).

Specs are tuples in the manner of ``PartitionSpec``: ``()`` replicates,
otherwise one entry a dim, ``None`` or the axis name.  The port's conv
kernels are OIHW where flax's are HWIO, so the rules run on the flax
shape and map back through the layout (``flax_shape``): the port shards
the same axis of a parameter that the JAX package shards.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_leaves

from gdn_tpu_torch.parallel import multihost

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]
# flax dim of each dim of a 4-D OIHW kernel (flax: HWIO)
_HWIO_OF_OIHW = (3, 2, 0, 1)


class Axis(NamedTuple):
    """One mesh dim as the collectives see it: its process group, its
    extent and this rank's place on it."""

    group: Any
    size: int
    rank: int


def create_mesh(num_devices: int = 0, axis_name: str = DATA_AXIS, spatial: int = 1,
                model: int = 1, device_type: str = "cuda"):
    """The DeviceMesh over the process group's ranks (``num_devices`` 0:
    all of them): ``(data, spatial, model)`` with the dims of extent 1
    but ``"data"`` dropped, as the JAX package's ``create_mesh`` builds
    it, and ranks laid out as its ``reshape`` lays out devices (data
    outermost, the trailing dims fastest).  None when one process runs
    without a group (one device, no mesh: the same math).  The extents
    must divide the device count.  A mesh of cards unless the caller asks
    for ``device_type="cpu"``; one without a card raises."""
    world = multihost.world_size()
    n = num_devices or world
    inner = spatial * model
    if inner > 1 and n % inner:
        raise ValueError(f"spatial={spatial} x model={model} does not divide "
                         f"{n} devices")
    if n != world:
        raise ValueError(f"num_devices={n} but {world} rank(s) run: start the ranks "
                         "with scripts' --num_devices, torchrun, or "
                         "parallel.multihost.run_ranks")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_mesh: no CUDA device for a mesh of cards; pass "
                           "device_type='cpu' for a mesh of CPU ranks")
    dims = [(axis_name, n // inner)]
    if spatial > 1:
        dims.append((SPATIAL_AXIS, spatial))
    if model > 1:
        dims.append((MODEL_AXIS, model))
    mesh = init_device_mesh(device_type, tuple(d for _, d in dims),
                            mesh_dim_names=tuple(k for k, _ in dims))
    # the group of "data" x "spatial" (a model rank's replicas of one
    # column): every rank makes every such group, in the same order
    mesh.pixel_group = dist.group.WORLD
    if model > 1:
        rows = torch.arange(n).view(-1, model)
        for m in range(model):
            g = dist.new_group(rows[:, m].tolist())
            if multihost.rank() % model == m:
                mesh.pixel_group = g
    return mesh


def _dim(mesh, name: str) -> Optional[Axis]:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return Axis(mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
                mesh.get_local_rank(name))


def spatial_axis(mesh) -> Optional[Axis]:
    """The ``"spatial"`` dim (image height), None when absent."""
    return _dim(mesh, SPATIAL_AXIS)


def model_axis(mesh) -> Optional[Axis]:
    """The ``"model"`` dim (output channels), None when absent."""
    return _dim(mesh, MODEL_AXIS)


def spatial_size(mesh) -> int:
    """Extent of the spatial axis (1 when absent / no mesh)."""
    ax = spatial_axis(mesh)
    return 1 if ax is None else ax.size


def model_size(mesh) -> int:
    """Extent of the model (tensor-parallel) axis (1 when absent)."""
    ax = model_axis(mesh)
    return 1 if ax is None else ax.size


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def data_group(mesh):
    """The process group of the ``"data"`` dim; None without a mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def pixel_group(mesh):
    """The group over which a pixel sum is global: ``"data"`` x
    ``"spatial"`` (the ranks that hold other rows or other images of one
    channel slice).  Loss counts, the reported terms and the parameter
    gradients are summed over it; the ``"model"`` ranks compute the same
    values and are not summed.  The data group on a 1-D mesh."""
    if mesh is None:
        return None
    if len(mesh.mesh_dim_names) == 1:
        return data_group(mesh)
    return mesh.pixel_group


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, detached (counts and
    logged values); ``t`` itself without a group."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# ------------------------------------------------------------- batch rows

def local_rows(n: int, mesh) -> Tuple[int, int]:
    """[start, end) of this rank's rows of ``n``: rows [r n/D, (r+1) n/D)."""
    d = data_size(mesh)
    assert n % d == 0, f"batch dim ({n}) not divisible by mesh axis {DATA_AXIS!r} ({d})"
    per = n // d
    r = data_rank(mesh)
    return r * per, (r + 1) * per


def check_rows(height: int, ax: Axis, dim: int = 1) -> None:
    """The JAX package's one rule for a spatial mesh (``_shard_tree``):
    the extent divides the image height.  Levels below it may split
    unevenly (``parallel.spatial``)."""
    assert height % ax.size == 0, (
        f"batch dim {dim} ({height}) not divisible by mesh axis {SPATIAL_AXIS!r} ({ax.size})")


def height_rows(batch: Dict[str, Any], mesh, dim: int = 1) -> Dict[str, Any]:
    """This rank's image rows (dim ``dim``) on a spatial mesh, as the
    JAX package's ``batch_sharding`` splits height on ``"spatial"``;
    the batch as it is otherwise."""
    ax = spatial_axis(mesh)
    if ax is None:
        return batch
    out = {}
    for k, v in batch.items():
        h = v.shape[dim]
        check_rows(h, ax, dim)
        per = h // ax.size
        out[k] = v.narrow(dim, ax.rank * per, per)
    return out


def _rows(batch: Dict[str, Any], mesh, dim: int) -> Dict[str, Any]:
    if mesh is None:
        return batch
    n = next(iter(batch.values())).shape[dim]
    s, e = local_rows(n, mesh)
    out = {k: v.narrow(dim, s, e - s) if dim else v[s:e] for k, v in batch.items()}
    return height_rows(out, mesh, dim + 1)


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows (dim 0) of a global batch, and on a spatial mesh
    its image rows (dim 1)."""
    return _rows(batch, mesh, 0)


def local_batch(batch: Dict[str, Any], mesh, global_batch: int,
                height: Optional[int] = None) -> Dict[str, Any]:
    """This rank's rows of a batch that holds the global batch (cut) or
    this rank's rows already (kept, as a pipeline or a device cache over
    the mesh yields them); any other row count raises.  On a spatial
    mesh, given the image ``height``, likewise its image rows: whole
    images are cut, this rank's rows kept (a pipeline augments whole
    images, and leaves the cut to the loop)."""
    if mesh is None:
        return batch
    n = next(iter(batch.values())).shape[0]
    if n == global_batch:
        batch = {k: v[slice(*local_rows(n, mesh))] for k, v in batch.items()}
    elif n * data_size(mesh) != global_batch:
        raise ValueError(f"a batch of {n} rows: expected the global batch ({global_batch}) "
                         f"or this rank's rows ({global_batch} / {data_size(mesh)})")
    s = spatial_size(mesh)
    if height is None or s == 1:
        return batch
    h = next(iter(batch.values())).shape[1]
    if h == height:
        return height_rows(batch, mesh)
    if h * s != height:
        raise ValueError(f"images of {h} rows: expected the whole height ({height}) or "
                         f"this rank's rows ({height} / {s})")
    return batch


def shard_stacked_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of a stacked ``steps_per_call`` batch
    {k: (K, B, ...)}: dim 1 (and its image rows, dim 2)."""
    return _rows(batch, mesh, 1)


# ------------------------------------------------ parameter placement rules

def flax_shape(shape) -> Tuple[int, ...]:
    """The JAX package's shape of a port parameter: 4-D kernels are
    OIHW here and HWIO there; every other parameter has one layout."""
    shape = tuple(shape)
    if len(shape) != 4:
        return shape
    return tuple(shape[_HWIO_OF_OIHW.index(f)] for f in range(4))


def _from_flax(spec: Spec, ndim: int) -> Spec:
    if not spec or ndim != 4:
        return tuple(spec)
    return tuple(spec[_HWIO_OF_OIHW[t]] for t in range(4))


def _tp_flax(shape, extent: int) -> Spec:
    if not shape or shape[-1] < extent or shape[-1] % extent:
        return ()
    return (*([None] * (len(shape) - 1)), MODEL_AXIS)


def _fsdp_flax(shape, extent: int) -> Spec:
    if not shape:
        return ()
    cands = [d for d in range(len(shape)) if shape[d] >= extent and shape[d] % extent == 0]
    if not cands:
        return ()
    best = max(cands, key=lambda d: shape[d])  # ties: the leading (flax) dim
    spec = [None] * len(shape)
    spec[best] = DATA_AXIS
    return tuple(spec)


def tensor_parallel_spec(shape, extent: int) -> Spec:
    """The flax trailing (output-channel) dim over "model" when it
    divides, in the port's layout; replicated otherwise."""
    return _from_flax(_tp_flax(flax_shape(shape), extent), len(tuple(shape)))


def fsdp_spec(shape, extent: int) -> Spec:
    """The parameter's largest divisible dim over "data", chosen on the
    flax shape (ties to the leading flax dim) and mapped to the port's
    layout: a (64, 64, 3, 3) OIHW kernel shards I, as JAX's HWIO one
    does.  No divisible dim: replicated."""
    return _from_flax(_fsdp_flax(flax_shape(shape), extent), len(tuple(shape)))


def param_mode(mesh_cfg) -> str:
    """Resolve MeshConfig -> parameter placement mode."""
    tp = getattr(mesh_cfg, "model_devices", 1) > 1
    fsdp = bool(getattr(mesh_cfg, "fsdp", False))
    if tp and fsdp:
        raise ValueError("model_devices>1 (tensor parallel) and fsdp are mutually "
                         "exclusive parameter placements")
    return "tp" if tp else ("fsdp" if fsdp else "replicated")


def tree_shardings(net: nn.Module, mesh, mode: str) -> Dict[str, Spec]:
    """The spec of each parameter of ``net`` under ``mode``, by name:
    "tp" by ``tensor_parallel_spec`` over the mesh's ``"model"`` dim
    (which it must have), "fsdp" by ``fsdp_spec`` over ``"data"``,
    otherwise replicated."""
    if mode == "tp":
        extent = model_size(mesh)
        assert extent > 1, "tp mode needs a 'model' mesh axis"
        rule = lambda s: tensor_parallel_spec(s, extent)  # noqa: E731
    elif mode == "fsdp":
        extent = data_size(mesh)
        rule = lambda s: fsdp_spec(s, extent)  # noqa: E731
    else:
        rule = lambda s: ()  # noqa: E731
    return {k: rule(tuple(p.shape)) for k, p in net.named_parameters()}


# --------------------------------------------- tensor-parallel placement

def tp_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards on ``"model"``, None when it does not."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def tp_slice(full: torch.Tensor, dim: Optional[int], ax: Axis) -> torch.Tensor:
    """This model rank's slice of a whole tensor (itself when ``dim`` is
    None)."""
    if dim is None:
        return full
    return full.chunk(ax.size, dim)[ax.rank]


def tp_gather(part: torch.Tensor, dim: Optional[int], ax: Axis) -> torch.Tensor:
    """The whole tensor from the model ranks' slices (every model rank
    calls it); ``part`` itself when ``dim`` is None."""
    if dim is None:
        return part
    part = part.detach().contiguous()
    parts = [torch.empty_like(part) for _ in range(ax.size)]
    dist.all_gather(parts, part, group=ax.group)
    return torch.cat(parts, dim=dim)


def _owner(net: nn.Module, name: str) -> nn.Module:
    """The block a parameter belongs to: its module, or the module above
    a bare conv holder (``Conv_0``, ``lateral_proj``, ``ConvTranspose_0``)."""
    path = name.split(".")[:-1]
    if path and path[-1] in ("Conv_0", "lateral_proj", "ConvTranspose_0"):
        path = path[:-1]
    return net.get_submodule(".".join(path))


def shard_columns(net: nn.Module, specs: Dict[str, Spec], ax: Axis) -> nn.Module:
    """Column parallelism in place: every parameter ``specs`` shards on
    ``"model"`` becomes this rank's slice of its output channels (its
    requires_grad kept), and each block that owns one gets ``tp = ax``,
    which routes its forward through ``parallel.tensor``."""
    for name, p in list(net.named_parameters()):
        dim = tp_dim(specs[name])
        if dim is None:
            continue
        module, leaf = net.get_submodule(".".join(name.split(".")[:-1])), name.split(".")[-1]
        part = tp_slice(p.detach(), dim, ax).clone()
        setattr(module, leaf, nn.Parameter(part, requires_grad=p.requires_grad))
        _owner(net, name).tp = ax
    return net


def place_rows(net: nn.Module, mesh) -> nn.Module:
    """On a spatial mesh, give every module ``sp`` = the ``"spatial"``
    axis: the blocks (the variants' and the heads' too) then take
    height-sharded activations (``parallel.spatial``), and so do the
    paired ladder and the shared decoder pass, which run the blocks'
    modules."""
    ax = spatial_axis(mesh)
    if ax is not None:
        for m in net.modules():
            m.sp = ax
    return net


# ----------------------------------------------------------- FSDP2 placement

def fsdp_units(net: nn.Module):
    """The modules ``fully_shard`` wraps before the root: each encoder
    block (the stem, each DownBlock) and each decoder block (each
    UpBlock)."""
    units = []
    for part in (getattr(net, "encoder", None), getattr(net, "decoder", None)):
        if part is None:
            continue
        units += [m for name, m in part.named_children()
                  if name == "stem" or name.startswith(("down", "up"))]
    return units


def shard_module(net: nn.Module, mesh, specs: Dict[str, Spec]) -> nn.Module:
    """FSDP2 over ``net`` in place: ``fully_shard`` on each of
    ``fsdp_units`` and on the root, every parameter sharded on the dim
    its spec names; one the spec leaves whole stays out of FSDP
    (``ignored_params``).  Gradients are summed over the ranks, not
    averaged: each rank backpropagates its share of the global loss."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims = {p: specs[k].index(DATA_AXIS) for k, p in net.named_parameters() if specs[k]}
    whole = {p for p in net.parameters() if p not in dims}

    def placement(p):
        return Shard(dims[p])

    modules = [*fsdp_units(net), net]
    for m in modules:
        fully_shard(m, mesh=fsdp_mesh(mesh), shard_placement_fn=placement,
                    ignored_params={p for p in m.parameters() if p in whole} or None)
    for m in modules:
        m.set_force_sum_reduction_for_comms(True)
        m.set_gradient_divide_factor(1.0)
    return net


def fsdp_mesh(mesh):
    """The DeviceMesh FSDP2 takes: the data mesh itself, or on a (data,
    spatial) mesh the same ranks laid out (spatial, data), made once
    (every rank calls it): HSDP replicates on its first dim and shards
    on the second."""
    if spatial_size(mesh) == 1:
        return mesh
    if getattr(mesh, "hsdp", None) is None:
        from torch.distributed.device_mesh import DeviceMesh

        d, s = data_size(mesh), spatial_size(mesh)
        mesh.hsdp = DeviceMesh(mesh.device_type, torch.arange(d * s).view(d, s).t(),
                               mesh_dim_names=(SPATIAL_AXIS, DATA_AXIS))
    return mesh.hsdp


def is_sharded(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def shard_axis(t) -> Optional[Tuple[int, Any, int, int]]:
    """(tensor dim, process group, extent, rank) of the mesh dim a
    sharded tensor is split over (FSDP's; under HSDP the other dim
    replicates), None where it is whole."""
    for i, pl in enumerate(t.placements):
        if pl.is_shard():
            m = t.device_mesh
            return pl.dim, m.get_group(i), m.size(i), m.get_local_rank(i)
    return None


def full_tensor(t):
    """A sharded tensor gathered whole, others as they are.  A c10d
    all-gather of the local shards (every rank calls it), not
    ``DTensor.full_tensor``: with torch 2.11 on an H100, DTensor's
    functional collectives over gloo with CUDA tensors end the process
    (SIGSEGV), and ranks that share a card run gloo."""
    if not is_sharded(t):
        return t
    part = t.to_local().contiguous()
    ax = shard_axis(t)
    if ax is None:
        return part
    dim, group, size, _ = ax
    parts = [torch.empty_like(part) for _ in range(size)]
    dist.all_gather(parts, part, group=group)
    return torch.cat(parts, dim=dim)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a sharded tensor; others as they are."""
    return t.to_local() if is_sharded(t) else t


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` laid out as ``like`` (a sharded
    tensor: its local chunk; a plain tensor: ``full``)."""
    ax = shard_axis(like) if is_sharded(like) else None
    if ax is None:
        return full
    dim, _, size, rank = ax
    return full.chunk(size, dim)[rank]


def is_fsdp(module: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


def in_forward(module: nn.Module, fn):
    """``fn()`` run as ``module``'s forward: on an FSDP2 unit its hooks
    then unshard the unit's parameters around the call (and reshard
    them after), and register the backward that unshards them again and
    reduce-scatters their gradients.  Code that reads a unit's weights
    outside its blocks' forwards (the fused-guidance pass) reads them
    here, and returns copies (``unit_weights``): the unsharded storage
    is freed at the reshard.  Elsewhere ``fn()`` as it is."""
    if not is_fsdp(module):
        return fn()
    # the instance attribute shadows the class's forward; the empty
    # argument is for FSDP2's root pre-forward, which (torch 2.11) indexes
    # the forward's arguments
    module.forward = lambda _: fn()
    try:
        return module(torch.empty(0))
    finally:
        del module.forward


def unit_weights(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s parameters by name: the parameters themselves, or on
    an FSDP2 unit copies of them whole, read inside its forward
    (``in_forward``; the copies carry the gradient back to it)."""
    if not is_fsdp(module):
        return dict(module.named_parameters())
    return in_forward(module, lambda: {k: p.clone() for k, p in module.named_parameters()})


def shard_state(state, mesh, mode: str):
    """Place a ``train.state.TrainState`` on ``mesh`` under ``mode`` and
    return ``(state, specs)``; pass ``specs`` to the step builders'
    ``state_sharding=``.

    "replicated": every tensor of the state on the mesh's device type
    broadcast from rank 0 (the optimizer's step counts stay on the
    host: they are the checkpoint's or zero on every rank).
    "fsdp": the net under FSDP2 (``shard_module``); the optimizer, the
    EMA and the accumulator are rebuilt on the sharded parameters and
    the state's values (a restored run's too) put back into them.
    "tp": the state broadcast from rank 0, then every parameter the rule
    shards cut to this model rank's output channels (``shard_columns``),
    and the optimizer, EMA and accumulator rebuilt on the slices with
    the state's values sliced into them.  On a spatial mesh the net's
    blocks take height-sharded activations (``place_rows``)."""
    specs = tree_shardings(state.net, mesh, mode)
    if mesh is None:
        return state, specs
    if mode == "fsdp":
        full = state.state_dict(copy=True)
        shard_module(state.net, mesh, specs)
        state.rebuild()
        state.mesh, state.mode, state.specs = mesh, mode, specs
        state.load_state_dict(full)
    elif mode == "tp":
        _broadcast(tree_leaves(state.state_dict()), mesh)
        full = state.state_dict(copy=True)
        shard_columns(state.net, specs, model_axis(mesh))
        state.rebuild()
        state.mesh, state.mode, state.specs = mesh, mode, specs
        state.load_state_dict(full)
    else:
        state.mesh, state.mode, state.specs = mesh, mode, specs
        _broadcast(tree_leaves(state.state_dict()), mesh)
    place_rows(state.net, mesh)
    return state, specs


def _broadcast(tensors, mesh) -> None:
    """Rank 0's values of the tensors on the mesh's device type, to
    every rank."""
    with torch.no_grad():
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type == mesh.device_type:
                dist.broadcast(t, src=0)


def shard_frozen(net: nn.Module, mesh, mode: str) -> nn.Module:
    """A frozen net (stage 2's D-net) placed as the trained one: under
    "fsdp" and "tp" sharded by the same rule (the JAX package shards it
    too), else broadcast from rank 0; on a spatial mesh its blocks take
    height-sharded activations.  A net already placed is left as it is."""
    if mesh is None or getattr(net, "placed", False) or any(
            is_sharded(p) for p in net.parameters()):
        return net
    specs = tree_shardings(net, mesh, mode)
    if mode == "fsdp":
        shard_module(net, mesh, specs)
    else:
        _broadcast(net.state_dict().values(), mesh)
        if mode == "tp":
            shard_columns(net, specs, model_axis(mesh))
        net.placed = True
    return place_rows(net, mesh)
