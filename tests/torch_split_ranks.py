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


def eval_samples(n: int = 8, seed: int = 5, hw=None):
    """Eval samples at the net's size (``hw``, default the small net's),
    GT at three sizes (~15% holes)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        gt = rng.uniform(0, 100, (1, *((20, 40), (16, 32), (33, 50))[i % 3])).astype(np.float32)
        gt[rng.uniform(size=gt.shape) < 0.15] = 0.0
        out.append({"rgb": rng.uniform(0, 1, (1, *(hw or R.HW), 3)).astype(np.float32),
                    "gt": gt})
    return out


def _eval(sd, out, mesh, cfg, name):
    """The G-net, placed on ``mesh``, through ``evaluate`` on
    ``eval_samples``: rank 0 writes the metrics."""
    from gdn_tpu_torch.evaluate import evaluate

    g = shard_frozen(R.nets(sd, 2, cfg)[0].requires_grad_(False), mesh, param_mode(cfg.mesh))
    res = evaluate(cfg, tsteps.make_eval_forward(cfg, g), eval_samples(hw=cfg.model.image_size),
                   verbose=False, mesh=mesh, device="cpu")
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


# ------------------------------------------ A10c: the knobs on every mesh

# Model variants the knob tests hold, as ModelConfig fields over the small
# net: three nets that between them take every variant site the JAX
# package has (the deconv UpBlock with its resize and bare activation,
# the add FusionBlock's lateral_proj, the coarse heads, a non-ELU
# GroupNorm, the biased norm="none" convs, the deconv's GroupNorm).
VARIANTS = {
    "deconv_add_ms_gelu": dict(upsample="deconv", fusion="add", multiscale_heads=True,
                               activation="gelu"),
    "none_relu": dict(norm="none", activation="relu"),
    "deconv_gn": dict(upsample="deconv", deconv_gn=True),
}
# stage 2's knobs: the shared decoder pass with its hand-written backward,
# and the paired encoder ladder under the autograd decoder pass
FG = dict(fused_guidance=True, fused_guidance_vjp=True)
FE = dict(fused_guidance=True, fused_encoders=True)


def knob_config(model=None, hw=R.HW, spatial_: int = 1, model_devices: int = 1,
                fsdp: bool = False, eval_batch: int = 2, **train) -> tcfg.Config:
    """The small net with the ModelConfig fields ``model`` at image size
    ``hw`` on a (spatial, model, fsdp) mesh config."""
    return tcfg.Config(model=tcfg.ModelConfig(**{**R.SMALL, "image_size": tuple(hw),
                                                 **(model or {})}),
                       loss=tcfg.LossConfig(use_pallas=False),
                       train=tcfg.TrainConfig(lr=1e-3, **train),
                       eval=tcfg.EvalConfig(batch_size=eval_batch),
                       mesh=tcfg.MeshConfig(spatial_devices=spatial_,
                                            model_devices=model_devices, fsdp=fsdp))


def knob_weights(model=None, seed: int = 3):
    """The D-net and the G-net (with its transferred decoder) of a variant
    of the small net, drawn by the port's init."""
    from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder

    cfg = knob_config(model)
    gen = torch.Generator().manual_seed(seed)
    d = init_params(cfg.model, gen, in_channels=1)
    g = transfer_stage1_decoder(init_params(cfg.model, gen, in_channels=3), d)
    return {"d": d, "g": g}


def batches_at(hw, n: int = 1, seed: int = 0):
    """``R.batches`` at another image size (numpy)."""
    old = R.HW
    R.HW = tuple(hw)
    try:
        return R.batches(n, seed)
    finally:
        R.HW = old


def _mutate_paired_gather():
    """A paired-ladder gather that joins the ranks' [D_r | G_r] halves as
    they come (all-gather of the whole slice): the mutation the TP test
    of the paired encoders must catch."""
    old = tensor._gather_pair
    tensor._gather_pair = lambda t, ax, dim: tensor.gather_from_model(t, ax, dim)
    return lambda: setattr(tensor, "_gather_pair", old)


def _mutate_deconv_halo():
    """A local transposed conv whose halo drops the row of the rank below
    (zeros where it should be): the mutation the deconv's SP test must
    catch."""
    from gdn_tpu_torch.models import blocks

    old = blocks.conv_transpose_rows
    real_halo = spatial.halo

    def mutant(x, weight, bias, padding, size, ax, rows=None):
        def halo(t, top, bottom, ax_, mode="zeros", dim=2):
            ext = real_halo(t, top, bottom, ax_, mode, dim)
            if ax_.rank < ax_.size - 1:
                ext = torch.cat([ext.narrow(dim, 0, ext.shape[dim] - 1),
                                 torch.zeros_like(ext.narrow(dim, 0, 1))], dim)
            return ext

        spatial.halo = halo
        try:
            return old(x, weight, bias, padding, size, ax, rows)
        finally:
            spatial.halo = real_halo

    blocks.conv_transpose_rows = mutant
    return lambda: setattr(blocks, "conv_transpose_rows", old)


def _mutate_odd_start():
    """An uneven layout that runs a stride-2 conv on each rank's rows
    though a shard starts on an odd row (as if it started one row
    later, on an even one): the mutation the uneven-height SP test must
    catch."""
    import torch.nn.functional as F

    from gdn_tpu_torch.models import blocks
    from gdn_tpu_torch.ops.conv import same_pads

    old = blocks.conv_rows

    def mutant(x, kernel, stride, ax, rows=None, bias=None, groups=1):
        k, h = kernel.shape[2], spatial.rows_of(x, ax, rows)
        if stride == 1 or spatial.conv_plan(h, k, stride, ax.size) is not None:
            return old(x, kernel, stride, ax, rows, bias, groups)
        t, b = same_pads(h, k, stride)
        o_s, o_e = spatial.row_bounds(-(-h // stride), ax)
        ext = spatial.halo(x, t, max(k - stride - t, b), ax, "zeros")
        l, r = same_pads(x.shape[3], kernel.shape[3], stride)
        y = F.conv2d(F.pad(ext, (l, r, 0, 0)), kernel, bias, stride, groups=groups)
        y = F.pad(y, (0, 0, 0, max(0, o_e - o_s - y.shape[2])))
        return y[:, :, :o_e - o_s].contiguous(memory_format=torch.channels_last)

    blocks.conv_rows = mutant
    return lambda: setattr(blocks, "conv_rows", old)


MUTANTS = {"paired_gather": _mutate_paired_gather, "deconv_halo": _mutate_deconv_halo,
           "odd_start": _mutate_odd_start}


def knob_scenarios(inp: str, out: str) -> None:
    """The cases of a knob test file (tests/test_torch_split_*.py): each
    a dict of name, cfg, stage, weights, batch (keys of the input's
    ``sd`` and ``batches``), and optionally ``mutant`` (a MUTANTS key) and
    ``bytes`` (each rank writes its bytes of every trained parameter);
    a case with ``eval`` runs the G-net through ``evaluate`` instead
    (``_eval``).  Rank 0 writes ``<name>.npz``; the meshes are made once
    by shape."""
    data = torch.load(inp, weights_only=False)
    meshes = {}
    r = multihost.rank()
    for case in data["cases"]:
        cfg = case["cfg"]
        key = (cfg.mesh.spatial_devices, cfg.mesh.model_devices)
        if key not in meshes:
            meshes[key] = create_mesh(0, spatial=key[0], model=key[1], device_type="cpu")
        if case.get("eval"):
            _eval(data["sd"][case["weights"]], out, meshes[key], cfg, case["name"])
            continue
        undo = MUTANTS[case["mutant"]]() if case.get("mutant") else None
        try:
            state, terms, tap = R.run(cfg, case["stage"], data["sd"][case["weights"]],
                                      data["batches"][case["batch"]], meshes[key])
        finally:
            if undo is not None:
                undo()
        _emit(out, case["name"], state, terms, tap)
        if case.get("bytes"):
            _save(os.path.join(out, f"{case['name']}.rank{r}.npz"), **R._bytes(state))
