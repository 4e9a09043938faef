"""The rank side of the port's tensor- and spatial-parallel tests
(tests/test_torch_tensor_parallel.py, tests/test_torch_spatial.py):
functions that run in the gloo ranks ``multihost.run_ranks`` spawns,
imported by the children by name.  They import torch and the port only.

Inputs and outputs as in ``torch_parallel_ranks``: each scenario reads
``inp`` (a ``torch.save`` file) and rank 0 writes ``<scenario>.npz`` of
the global values (every TP slice gathered whole); a rank's own values go
to ``<scenario>.rank<r>.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from gdn_tpu_torch.parallel import multihost, spatial, tensor
from gdn_tpu_torch.parallel.mesh import (
    create_mesh, local, model_axis, param_mode, shard_batch, shard_frozen, shard_state,
    tp_dim,
)
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.train.state import TrainState

import torch_parallel_ranks as R

FUSED = ("use_pallas_convgn_bt", "use_pallas_convgn_s2", "use_pallas_fusion_bt")


def config(spatial_: int = 1, model: int = 1, route: str = "unfused", flags=(), groups=8,
           eval_batch: int = 1, **train):
    """The small net of ``torch_parallel_ranks`` on a (spatial, model)
    mesh config, with the fused-kernel ``flags`` set and ``groups``
    GroupNorm groups a site."""
    return tcfg.Config(model=tcfg.ModelConfig(**R.SMALL, group_norm_groups=groups,
                                              **{f: True for f in flags}),
                       loss=tcfg.LossConfig(use_pallas=route == "fused"),
                       train=tcfg.TrainConfig(lr=1e-3, **train),
                       eval=tcfg.EvalConfig(batch_size=eval_batch),
                       mesh=tcfg.MeshConfig(spatial_devices=spatial_, model_devices=model))


def _save(path, **arrays):
    np.savez(path, **{k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                      for k, v in arrays.items()})


def _emit(out, name, state, terms, tap, **more):
    arrays = {**R.terms_arrays(terms), **R.state_arrays(state, tap), **more}
    if multihost.rank() == 0:
        _save(os.path.join(out, f"{name}.npz"), **arrays)


def _tp_bytes(state):
    """This rank's bytes of each trained parameter and of its two Adam
    moments, its whole size, and whether the TP rule slices it."""
    out = {}
    dims = state._tp_dims()
    for k, p in zip(state.names, state.params):
        moments = state.optimizer.state.get(p, {})
        full = p.numel() * p.element_size() * (model_axis(state.mesh).size if k in dims else 1)
        out[f"pbytes/{k}"] = local(p).nbytes
        out[f"full/{k}"] = full
        out[f"obytes/{k}"] = sum(v.nbytes for n, v in moments.items() if n != "step")
        out[f"sharded/{k}"] = int(k in dims)
    return out


def _mutate_gather():
    """A gather whose backward sums the ranks' gradients (reduce-scatter):
    the mutation the TP tests must catch."""
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.ax.group)
        return g.chunk(ctx.ax.size, ctx.dim)[ctx.ax.rank], None, None

    old = tensor._GatherFromModel.backward
    tensor._GatherFromModel.backward = staticmethod(backward)
    return lambda: setattr(tensor._GatherFromModel, "backward", staticmethod(old))


def _mutate_halo():
    """A conv halo that drops the row of the rank below (zeros where it
    should be): the mutation the SP tests must catch."""
    old = spatial.halo

    def halo(x, top, bottom, ax, mode="zeros", dim=2):
        ext = old(x, top, bottom, ax, mode, dim)
        if ax.rank < ax.size - 1 and bottom and mode == "zeros":
            keep = ext.narrow(dim, 0, ext.shape[dim] - 1)
            return torch.cat([keep, torch.zeros_like(ext.narrow(dim, 0, 1))], dim)
        return ext

    spatial.halo = halo
    return lambda: setattr(spatial, "halo", old)


def eval_samples(n: int = 8, seed: int = 5):
    """Eval samples at the net's size, GT at three sizes (~15% holes)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        gt = rng.uniform(0, 100, (1, *((20, 40), (16, 32), (33, 50))[i % 3])).astype(np.float32)
        gt[rng.uniform(size=gt.shape) < 0.15] = 0.0
        out.append({"rgb": rng.uniform(0, 1, (1, *R.HW, 3)).astype(np.float32), "gt": gt})
    return out


def _eval(sd, out, mesh, cfg, name):
    """The G-net, placed on ``mesh``, through ``evaluate`` on
    ``eval_samples``: rank 0 writes the metrics."""
    from gdn_tpu_torch.evaluate import evaluate

    g = shard_frozen(R.nets(sd, 2, cfg)[0].requires_grad_(False), mesh, param_mode(cfg.mesh))
    res = evaluate(cfg, tsteps.make_eval_forward(cfg, g), eval_samples(), verbose=False,
                   mesh=mesh, device="cpu")
    if multihost.rank() == 0:
        _save(os.path.join(out, f"{name}.npz"), **{k: v for k, v in res.items()
                                                   if not k.endswith("fps")})


def _checkpoint_round_trip(sd, b, out, mesh, cfg, name):
    """Two steps with an EMA and a clip, a checkpoint written by rank 0 in
    one device's layout, restored into a fresh placed state (cut again),
    and one more step."""
    ck = os.path.join(out, name)
    state, terms, tap = R.run(cfg, 1, sd, b[:2], mesh)
    save_checkpoint(ck, state.step, state, use_async=False)
    dist.barrier()
    st = TrainState(R.nets(sd, 1, cfg)[0], cfg.train, 10)
    st, specs = shard_state(st, mesh, param_mode(cfg.mesh))
    st = restore_checkpoint(ck, st)
    tap2 = R.GradTap(st)
    st, t = tsteps.make_stage1_step(cfg, mesh, specs)(st, shard_batch(b[2], mesh))
    _emit(out, f"{name}_resumed", st, [{k: float(v) for k, v in t.items()}], tap2)


def tp_scenarios(inp: str, out: str) -> None:
    """Every scenario of tests/test_torch_tensor_parallel.py (model=2)."""
    data = torch.load(inp, weights_only=False)
    sd, b = data["sd"], data["batches"]
    mesh = create_mesh(0, model=2, device_type="cpu")
    r = multihost.rank()
    for stage in (1, 2):
        state, terms, tap = R.run(config(model=2), stage, sd, b[:1], mesh)
        _emit(out, f"tp_s{stage}", state, terms, tap)
        _save(os.path.join(out, f"tp_s{stage}.rank{r}.npz"), **_tp_bytes(state))
    for tag, flags in (("fused", FUSED), ("fusion", ("use_pallas_fusion",))):
        state, terms, tap = R.run(config(model=2, route="fused", flags=flags), 2, sd, b[:1],
                                  mesh)
        _emit(out, f"tp_{tag}", state, terms, tap)
    # one group a site: no channel slice holds a whole group
    state, terms, tap = R.run(config(model=2, flags=FUSED, groups=1), 2, sd, b[:1], mesh)
    _emit(out, "tp_one_group", state, terms, tap)
    state, terms, tap = R.run(config(model=2, grad_accum=2, ema_decay=0.9), 2, sd, b[:2], mesh)
    _emit(out, "tp_accum_ema", state, terms, tap)
    state, terms, tap = R.run(config(model=2, steps_per_call=2), 1, sd, b[:2], mesh,
                              stacked=True)
    _emit(out, "tp_multistep", state, terms, tap)
    state, terms, tap = R.run(config(model=2), 1, sd, b[:2], mesh)
    _emit(out, "tp_two_steps", state, terms, tap)
    _checkpoint_round_trip(sd, b, out, mesh, config(model=2, ema_decay=0.9, grad_clip=0.05),
                           "tp_ckpt")
    undo = _mutate_gather()
    try:
        state, terms, tap = R.run(config(model=2), 1, sd, b[:1], mesh)
    finally:
        undo()
    _emit(out, "tp_mutant", state, terms, tap)
    assert tp_dim(state.specs["encoder.stem.Conv_0.kernel"]) == 0
    _eval(sd, out, mesh, config(model=2, eval_batch=2), "tp_eval")
    rows = create_mesh(0, spatial=2, device_type="cpu")  # the spatial dim alone
    for stage in (1, 2):
        state, terms, tap = R.run(config(spatial_=2), stage, sd, data["sp_batches"], rows)
        _emit(out, f"sp_alone_s{stage}", state, terms, tap)


def sp_scenarios(inp: str, out: str) -> None:
    """Every scenario of tests/test_torch_spatial.py (4 ranks: data 2 x
    spatial 2, and spatial 2 x model 2)."""
    data = torch.load(inp, weights_only=False)
    sd, b = data["sd"], data["batches"]
    mesh = create_mesh(0, spatial=2, device_type="cpu")
    for stage in (1, 2):
        state, terms, tap = R.run(config(spatial_=2, route="fused"), stage, sd, b[:1], mesh)
        _emit(out, f"sp_s{stage}", state, terms, tap)
    for tag, flags in (("fused", FUSED), ("fusion", ("use_pallas_fusion",))):
        state, terms, tap = R.run(config(spatial_=2, flags=flags), 2, sd, b[:1], mesh)
        _emit(out, f"sp_{tag}", state, terms, tap)
    state, terms, tap = R.run(config(spatial_=2, grad_accum=2, ema_decay=0.9), 2, sd, b[:2],
                              mesh)
    _emit(out, "sp_accum_ema", state, terms, tap)
    state, terms, tap = R.run(config(spatial_=2, steps_per_call=2), 1, sd, b[:2], mesh,
                              stacked=True)
    _emit(out, "sp_multistep", state, terms, tap)
    state, terms, tap = R.run(config(spatial_=2), 1, sd, b[:2], mesh)
    _emit(out, "sp_two_steps", state, terms, tap)
    state, terms, tap = R.run(config(spatial_=2, remat=True), 1, sd, b[:1], mesh)
    _emit(out, "sp_remat", state, terms, tap)
    undo = _mutate_halo()
    try:
        state, terms, tap = R.run(config(spatial_=2), 1, sd, b[:1], mesh)
    finally:
        undo()
    _emit(out, "sp_mutant", state, terms, tap)
    _eval(sd, out, mesh, config(spatial_=2, eval_batch=4), "sp_eval")
    both = create_mesh(0, spatial=2, model=2, device_type="cpu")
    state, terms, tap = R.run(config(spatial_=2, model=2), 2, sd, b[:1], both)
    _emit(out, "sp_tp_s2", state, terms, tap)
