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
  its gradient all-reduced like data parallel's).
- **TP and SP** (a ``"model"`` or ``"spatial"`` dim) split one image's
  work and need hand-written collectives inside the forward: refused,
  naming ROADMAP.md Queue A item 10b.  Their shape rules
  (``tensor_parallel_spec``) are ported.

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

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_leaves

from gdn_tpu_torch.parallel import multihost

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
LATER = "ROADMAP.md Queue A item 10b (tensor and spatial parallelism)"

Spec = Tuple[Optional[str], ...]
# flax dim of each dim of a 4-D OIHW kernel (flax: HWIO)
_HWIO_OF_OIHW = (3, 2, 0, 1)


def create_mesh(num_devices: int = 0, axis_name: str = DATA_AXIS, spatial: int = 1,
                model: int = 1, device_type: Optional[str] = None):
    """The ``"data"`` DeviceMesh over the process group's ranks
    (``num_devices`` 0: all of them), or None when one process runs
    without a group (one device, no mesh: the same math).  A spatial or
    model extent > 1 raises NotImplementedError (Queue A item 10b) once
    it divides the device count, as the JAX package checks."""
    world = multihost.world_size()
    n = num_devices or world
    inner = spatial * model
    if inner > 1:
        if n % inner:
            raise ValueError(f"spatial={spatial} x model={model} does not divide "
                             f"{n} devices")
        raise NotImplementedError(
            f"spatial={spatial} / model={model} mesh axes are not ported to "
            f"gdn_tpu_torch yet; see {LATER}")
    if n != world:
        raise ValueError(f"num_devices={n} but {world} rank(s) run: start the ranks "
                         "with scripts' --num_devices, torchrun, or "
                         "parallel.multihost.run_ranks")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def spatial_size(mesh) -> int:
    """Extent of the spatial axis (1 when absent / no mesh)."""
    if mesh is None or SPATIAL_AXIS not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(SPATIAL_AXIS))


def model_size(mesh) -> int:
    """Extent of the model (tensor-parallel) axis (1 when absent)."""
    if mesh is None or MODEL_AXIS not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def data_group(mesh):
    """The process group of the ``"data"`` dim; None without a mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


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


def _rows(batch: Dict[str, Any], mesh, dim: int) -> Dict[str, Any]:
    if mesh is None:
        return batch
    n = next(iter(batch.values())).shape[dim]
    s, e = local_rows(n, mesh)
    return {k: v.narrow(dim, s, e - s) if dim else v[s:e] for k, v in batch.items()}


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows (dim 0) of a global batch."""
    return _rows(batch, mesh, 0)


def local_batch(batch: Dict[str, Any], mesh, global_batch: int) -> Dict[str, Any]:
    """This rank's rows of a batch that holds the global batch (cut) or
    this rank's rows already (kept, as a pipeline or a device cache over
    the mesh yields them); any other row count raises."""
    if mesh is None:
        return batch
    n = next(iter(batch.values())).shape[0]
    if n == global_batch:
        return shard_batch(batch, mesh)
    if n * data_size(mesh) == global_batch:
        return batch
    raise ValueError(f"a batch of {n} rows: expected the global batch ({global_batch}) "
                     f"or this rank's rows ({global_batch} / {data_size(mesh)})")


def shard_stacked_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of a stacked ``steps_per_call`` batch
    {k: (K, B, ...)}: dim 1."""
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
    """The spec of each parameter of ``net`` under ``mode``, by name."""
    if mode == "tp":
        raise NotImplementedError(f"tensor-parallel placement: see {LATER}")
    extent = data_size(mesh)
    rule = (lambda s: fsdp_spec(s, extent)) if mode == "fsdp" else (lambda s: ())
    return {k: rule(tuple(p.shape)) for k, p in net.named_parameters()}


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
        fully_shard(m, mesh=mesh, shard_placement_fn=placement,
                    ignored_params={p for p in m.parameters() if p in whole} or None)
    for m in modules:
        m.set_force_sum_reduction_for_comms(True)
        m.set_gradient_divide_factor(1.0)
    return net


def is_sharded(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full_tensor(t):
    """A sharded tensor gathered whole, others as they are.  A c10d
    all-gather of the local shards (every rank calls it), not
    ``DTensor.full_tensor``: with torch 2.11 on an H100, DTensor's
    functional collectives over gloo with CUDA tensors end the process
    (SIGSEGV), and ranks that share a card run gloo."""
    if not is_sharded(t):
        return t
    (pl,) = t.placements
    mesh = t.device_mesh
    part = t.to_local().contiguous()
    if not pl.is_shard():
        return part
    parts = [torch.empty_like(part) for _ in range(mesh.size())]
    dist.all_gather(parts, part, group=mesh.get_group())
    return torch.cat(parts, dim=pl.dim)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a sharded tensor; others as they are."""
    return t.to_local() if is_sharded(t) else t


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` laid out as ``like`` (a sharded
    tensor: its local chunk; a plain tensor: ``full``)."""
    if not is_sharded(like):
        return full
    (pl,) = like.placements
    if not pl.is_shard():
        return full
    mesh = like.device_mesh
    return full.chunk(mesh.size(), pl.dim)[mesh.get_local_rank()]


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
    "tp": refused (Queue A item 10b)."""
    specs = tree_shardings(state.net, mesh, mode)
    if mesh is None:
        return state, specs
    if mode == "fsdp":
        full = state.state_dict(copy=True)
        shard_module(state.net, mesh, specs)
        state.rebuild()
        state.mesh, state.mode, state.specs = mesh, mode, specs
        state.load_state_dict(full)
    else:
        state.mesh, state.mode, state.specs = mesh, mode, specs
        _broadcast(tree_leaves(state.state_dict()), mesh)
    return state, specs


def _broadcast(tensors, mesh) -> None:
    """Rank 0's values of the tensors on the mesh's device type."""
    with torch.no_grad():
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type == mesh.device_type:
                dist.broadcast(t, group=data_group(mesh), group_src=0)


def shard_frozen(net: nn.Module, mesh, mode: str) -> nn.Module:
    """A frozen net (stage 2's D-net) placed as the trained one: under
    "fsdp" sharded by the same rule (the JAX package shards it too),
    else broadcast from rank 0.  A net already sharded is left as it is."""
    if mesh is None or any(is_sharded(p) for p in net.parameters()):
        return net
    if mode == "fsdp":
        return shard_module(net, mesh, tree_shardings(net, mesh, mode))
    tree_shardings(net, mesh, mode)  # refuses "tp"
    _broadcast(net.state_dict().values(), mesh)
    return net
