"""The port's parallel rules against the JAX package's, without
processes: the FSDP and TP placement rules on every parameter of the
full-width KITTI nets through the OIHW/HWIO layout, ``param_mode``, the
batch rows, ``local_batch_slice``, the backend rule, the rank's device,
and the mesh configs the JAX package accepts (what Queue A item 10b left
to item 10c included) and refuses."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.parallel import mesh as jmesh
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.parallel import mesh as tmesh
from gdn_tpu_torch.parallel import multihost
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.train.state import TrainState

import torch_parallel_ranks as R

# torch dim t of a 4-D OIHW kernel is flax dim OIHW_TO_HWIO[t] of HWIO
OIHW_TO_HWIO = (3, 2, 0, 1)
# the shapes do not depend on the image size: a small one keeps the trace cheap
HW = (32, 64)


@functools.lru_cache(maxsize=None)
def _flax_leaves(net: str):
    cfg = jcfg.kitti_config(**{"model.image_size": HW}).model
    cls, c = (JDtoD, 1) if net == "d" else (JRtoD, 3)
    shapes = jax.eval_shape(cls(cfg=cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, c)))["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        out[".".join(p.key for p in path)] = tuple(leaf.shape)
    return out


@functools.lru_cache(maxsize=None)
def _port_shapes(net: str):
    cfg = tcfg.kitti_config().model
    m = DtoDNet(cfg) if net == "d" else RtoDNet(cfg)
    return {k: tuple(p.shape) for k, p in m.named_parameters()}


def _mapped(jax_spec, ndim):
    """A JAX PartitionSpec as the port's tuple, through the layout."""
    spec = tuple(jax_spec)
    if not spec:
        return ()
    spec = spec + (None,) * (ndim - len(spec))
    return tuple(spec[OIHW_TO_HWIO[t]] for t in range(4)) if ndim == 4 else spec


@pytest.mark.parametrize("extent", [2, 4, 8])
@pytest.mark.parametrize("net", ["d", "g"])
@pytest.mark.parametrize("rule", ["fsdp", "tp"])
def test_placement_rule_matches_jax_on_every_parameter(net, extent, rule):
    flax = _flax_leaves(net)
    port = _port_shapes(net)
    assert set(flax) == set(port) and len(port) > 60
    jrule = jmesh.fsdp_spec if rule == "fsdp" else jmesh.tensor_parallel_spec
    trule = tmesh.fsdp_spec if rule == "fsdp" else tmesh.tensor_parallel_spec
    sharded = 0
    for k, shape in port.items():
        assert tmesh.flax_shape(shape) == flax[k], k
        want = _mapped(jrule(flax[k], extent), len(shape))
        assert trule(shape, extent) == want, k
        sharded += bool(want)
    assert sharded > len(port) // 2


def test_fsdp_rule_keeps_jax_tie_break_through_the_layout():
    """(3, 3, 64, 64) HWIO: JAX shards I (the leading of the tied dims);
    the port's (64, 64, 3, 3) OIHW shards I too, not O."""
    assert tuple(jmesh.fsdp_spec((3, 3, 64, 64), 2)) == (None, None, "data", None)
    assert tmesh.fsdp_spec((64, 64, 3, 3), 2) == (None, "data", None, None)
    assert tmesh.fsdp_spec((1, 16, 3, 3), 8) == (None, "data", None, None)
    assert tmesh.fsdp_spec((3,), 2) == ()
    assert tmesh.tensor_parallel_spec((16, 8, 3, 3), 4) == ("model", None, None, None)
    assert tmesh.tensor_parallel_spec((1, 8, 3, 3), 4) == ()


@pytest.mark.parametrize("kw,mode", [
    ({}, "replicated"), ({"fsdp": True}, "fsdp"), ({"model_devices": 4}, "tp"),
    ({"model_devices": 2, "fsdp": True}, ValueError),
])
def test_param_mode_matches_jax(kw, mode):
    jm = jcfg.MeshConfig(**kw)
    fake = type("M", (), dict(model_devices=jm.model_devices, fsdp=jm.fsdp))()
    if mode is ValueError:
        for fn, cfg in ((jmesh.param_mode, jm), (tmesh.param_mode, fake)):
            with pytest.raises(ValueError, match="mutually exclusive"):
                fn(cfg)
        with pytest.raises(ValueError, match="mutually exclusive"):
            tcfg.MeshConfig(**kw)
        return
    assert jmesh.param_mode(jm) == tmesh.param_mode(fake) == mode


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_batch_slice_matches_jax(monkeypatch, world):
    """Contiguous, disjoint, covering slices (JAX: tests/test_utils.py),
    and a global batch that does not divide refused."""
    slices = []
    for r in range(world):
        monkeypatch.setattr(multihost, "world_size", lambda w=world: w)
        monkeypatch.setattr(multihost, "rank", lambda r=r: r)
        slices.append(multihost.local_batch_slice(32))
    per = 32 // world
    assert slices == [(r * per, (r + 1) * per) for r in range(world)]
    if world > 1:
        with pytest.raises(AssertionError, match="divide"):
            multihost.local_batch_slice({2: 31, 4: 30}[world])


def test_batch_rows_of_each_rank():
    batch = {"x": torch.arange(8 * 3).reshape(8, 3), "y": torch.arange(8)}
    stacked = {"x": torch.arange(2 * 8).reshape(2, 8)}
    rows = [tmesh.shard_batch(batch, R.StubMesh(4, r)) for r in range(4)]
    assert torch.equal(torch.cat([b["x"] for b in rows]), batch["x"])
    assert [b["y"].tolist() for b in rows] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    got = tmesh.shard_stacked_batch(stacked, R.StubMesh(2, 1))["x"]
    assert torch.equal(got, stacked["x"][:, 4:])
    assert tmesh.shard_batch(batch, None) is batch
    with pytest.raises(AssertionError, match="not divisible"):
        tmesh.shard_batch({"x": torch.zeros(6)}, R.StubMesh(4))
    # a loop's or pipeline's batch: the global one is cut, a rank's kept
    mine = tmesh.local_batch(batch, R.StubMesh(4, 3), 8)
    assert mine["y"].tolist() == [6, 7]
    assert tmesh.local_batch(mine, R.StubMesh(4, 3), 8) is mine
    with pytest.raises(ValueError, match="a batch of 3 rows"):
        tmesh.local_batch({"x": torch.zeros(3)}, R.StubMesh(4), 8)


def test_spatial_and_model_axes_are_refused_naming_10b():
    """The axes Queue A item 10b ported are accepted, and so is what it
    left to item 10c (FSDP on a spatial mesh); TP with FSDP stays refused
    as in the JAX package, and the shape checks stay."""
    for kw in ({"spatial_devices": 2}, {"model_devices": 2},
               {"spatial_devices": 2, "fsdp": True}):
        tcfg.MeshConfig(**kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tcfg.MeshConfig(model_devices=2, fsdp=True)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.create_mesh(3, spatial=2)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.create_mesh(1, model=2)
    with pytest.raises(AssertionError, match="model"):
        tmesh.tree_shardings(torch.nn.Linear(2, 2), R.StubMesh(2), "tp")
    cfg = R.config()
    state = TrainState(R.nets(R.weights(), 1, cfg)[0], cfg.train, 2)
    with pytest.raises(AssertionError, match="model"):
        tmesh.shard_state(state, R.StubMesh(2), "tp")
    specs = tmesh.tree_shardings(torch.nn.Conv2d(3, 8, 3), _ModelMesh(), "tp")
    assert specs == {"weight": ("model", None, None, None), "bias": ("model",)}
    assert tmesh.spatial_size(R.StubMesh(2)) == tmesh.model_size(None) == 1


class _ModelMesh(R.StubMesh):
    """A (data 1, model 2) mesh as rank 0 sees it."""

    mesh_dim_names = ("data", "model")

    def __init__(self):
        super().__init__(2)


def test_one_process_has_no_mesh_and_more_ranks_must_run():
    assert tmesh.create_mesh(0) is None and tmesh.create_mesh(1) is None
    with pytest.raises(ValueError, match="num_devices=2 but 1 rank"):
        tmesh.create_mesh(2)
    with pytest.raises(ValueError, match="num_devices must be >= 0"):
        tcfg.MeshConfig(num_devices=-1)


def test_maybe_initialize_without_a_coordinator(monkeypatch):
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize() is False
    with pytest.raises(ValueError, match="no coordinator_address"):
        multihost.maybe_initialize(num_processes=2, process_id=0)


@pytest.mark.parametrize("device,world,local,cards,want", [
    ("cpu", 2, 2, 0, "gloo"),
    ("cuda", 2, 2, 2, "nccl"),
    ("cuda", 1, 1, 1, "nccl"),
    ("cuda", 2, 2, 1, "gloo"),
    ("cuda", 16, 8, 8, "nccl"),
])
def test_backend_rule(monkeypatch, device, world, local, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, why = multihost.choose_backend(device, world, local)
    assert backend == want and why


@pytest.mark.parametrize("local_rank,cards,index", [(0, 1, 0), (1, 1, 0), (3, 2, 1)])
def test_a_rank_resolves_its_own_card(monkeypatch, local_rank, cards, index):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    assert tcfg.resolve_device() == torch.device("cuda", index)
    assert tcfg.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert tcfg.resolve_device("cpu") == torch.device("cpu")


def test_mesh_steps_refuse_what_they_cannot_train():
    """An unplaced state under a mesh (its gradients would not be summed).
    fused_guidance under FSDP, once refused here, trains as in the JAX
    package: it reads the units' weights inside their forwards
    (tests/test_torch_split_model.py holds it against JAX's FSDP step)."""
    cfg = R.config()
    state = TrainState(R.nets(R.weights(), 1, cfg)[0], cfg.train, 2)
    step = tsteps.make_stage1_step(cfg, mesh=R.StubMesh(2))
    batch = {k: torch.from_numpy(v) for k, v in R.batches(1)[0].items()}
    with pytest.raises(ValueError, match="needs a placed state"):
        step(state, batch)
    fused = R.config(fsdp=True, fused_guidance=True)
    assert tsteps._stage2_loss_fn(fused) is tsteps._stage2_loss_fused
    tsteps.make_stage2_step(fused, mesh=R.StubMesh(2))
    tsteps.make_stage2_step(R.config(fused_guidance=True), mesh=R.StubMesh(2))
