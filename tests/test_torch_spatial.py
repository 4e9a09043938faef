"""Spatially parallel training of the PyTorch port over four gloo ranks
on the CPU: ``create_mesh(4, spatial=2)`` (data 2 x spatial 2: each
rank holds half the images' rows of half the batch), against the JAX
package's steps on the same 2-D mesh and against one process; and
spatial x model (2 x 2) against one process.

The ranks are spawned once for the file
(``torch_split_ranks.sp_scenarios``).  At 16 x 32 the shards hold 8, 4
and 2 rows at the three levels, so a halo crosses every level: the 7x7
stem's 3 rows, SSIM's 5 (reflected at the image's edges only), the
stride-2 convs' one row from below.  The config asks for the fused loss;
a spatial mesh routes it to the plain terms, as the JAX package does.
Bounds as tests/test_torch_tensor_parallel.py's.  A mutant whose conv
halo drops the row from below must miss JAX's gradients.
"""

import os

import numpy as np
import pytest
import torch

from gdn_tpu.parallel import mesh as jmesh
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.parallel import mesh as tmesh
from gdn_tpu_torch.parallel.multihost import run_ranks
from gdn_tpu_torch.train import steps as tsteps

import jax_mesh_ref as J
import torch_parallel_ranks as R
import torch_split_ranks as S

TERMS = dict(atol=1e-4, rtol=1e-3)
GRADS = dict(rtol=5e-4, atol=1e-6)
# the JAX mesh the port's (data 2, spatial 2) run is held against
JAX_MESH = dict(num_devices=4, spatial=2)
# The gradient bound sits at fp32 summation noise for these nets: held
# against a float64 run of the same step, the JAX package's own stage-1
# gradients on this mesh miss it by 1.18x, 1.42x and 1.45x the bound on
# input seeds 0, 1 and 3 (and on one device by up to 2.2x).  On seed 2
# they lie within 0.42x of it, so the reference can tell the port apart.
SEED = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    old, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "4"  # run_ranks gives each of 4 ranks one
    try:
        tmp = tmp_path_factory.mktemp("spatial")
        sd = R.weights()
        host = R.batches(2, seed=SEED)
        tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in host]
        inp = str(tmp / "inputs.pt")
        torch.save({"sd": sd, "batches": tb}, inp)
        run_ranks(S.sp_scenarios, 4, (inp, str(tmp)), device_type="cpu", timeout=150)
        d, g = J.to_flax(sd["d"]), J.to_flax(sd["g"])
        mesh = jmesh.create_mesh(**JAX_MESH)
        jax_ref = {s: J.mesh_grads(s, d if s == 1 else g, d, host[0], mesh) for s in (1, 2)}
        yield dict(dir=tmp, sd=sd, batches=tb, jax=jax_ref, single={})
    finally:
        torch.set_num_threads(old)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env


def _load(run, name):
    with np.load(os.path.join(run["dir"], f"{name}.npz")) as z:
        return dict(z)


def _section(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _close(got, want, **tol):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, **tol)


def _single(run, cfg, stage, n=1, **kw):
    key = (cfg, stage, n, tuple(sorted(kw.items())))
    if key not in run["single"]:
        state, terms, tap = R.run(cfg, stage, run["sd"], run["batches"][:n], None, **kw)
        run["single"][key] = {**R.terms_arrays(terms), **R.state_arrays(state, tap)}
    return run["single"][key]


@pytest.mark.parametrize("stage", [1, 2])
def test_sp_terms_match_jax_mesh_step(run, stage):
    _close(_section(_load(run, f"sp_s{stage}"), "term/0/"), run["jax"][stage][0], **TERMS)


@pytest.mark.parametrize("stage", [1, 2])
def test_sp_grads_match_jax_mesh_step(run, stage):
    got = _section(_load(run, f"sp_s{stage}"), "grad/0/")
    _close(got, {k: v for k, v in run["jax"][stage][1].items() if k in got}, **GRADS)


@pytest.mark.parametrize("tag,flags", [("fused", S.FUSED), ("fusion", ("use_pallas_fusion",))])
def test_sp_fused_conv_routes_gathered_match_single_process(run, tag, flags):
    """The fused conv kernels (rows 4-9) have no halo form: the rows are
    gathered around each call and split again, and stage 2 is one
    process's."""
    want = _single(run, S.config(flags=flags), 2)
    got = _load(run, f"sp_{tag}")
    _close(_section(got, "grad/0/"), _section(want, "grad/0/"), **GRADS)
    _close(_section(got, "term/0/"), _section(want, "term/0/"), **TERMS)


def test_sp_grad_accum_and_ema_match_single_process(run):
    want = _single(run, S.config(grad_accum=2, ema_decay=0.9), 2, n=2)
    got = _load(run, "sp_accum_ema")
    assert "grad/1/" not in " ".join(got)
    for prefix in ("grad/0/", "param/", "ema/"):
        _close(_section(got, prefix), _section(want, prefix), **GRADS)


def test_sp_steps_per_call_matches_single_process(run):
    """Two steps a call: the first step's gradients as one process's, the
    call as two single SP steps exactly (see the TP file's twin)."""
    want = _single(run, S.config(steps_per_call=2), 1, n=2, stacked=True)
    got = _load(run, "sp_multistep")
    _close(_section(got, "grad/0/"), _section(want, "grad/0/"), **GRADS)
    singles = _load(run, "sp_two_steps")
    for prefix in ("grad/0/", "grad/1/", "param/"):
        _close(_section(got, prefix), _section(singles, prefix), rtol=0, atol=0)


def test_sp_remat_matches_jax_mesh_step(run):
    got = _section(_load(run, "sp_remat"), "grad/0/")
    _close(got, {k: v for k, v in run["jax"][1][1].items() if k in got}, **GRADS)


def test_sp_mutant_without_halo_row_is_caught(run):
    """The mutation check: a conv halo that drops the row from below
    changes the loss and the gradients past the bounds."""
    got = _load(run, "sp_mutant")
    grads = _section(got, "grad/0/")
    with pytest.raises(AssertionError):
        _close(grads, {k: v for k, v in run["jax"][1][1].items() if k in grads}, **GRADS)


def test_spatial_and_model_axes_compose(run):
    """spatial 2 x model 2 (data 1): channel slices of height shards, the
    split GroupNorm on each rank's groups; stage 2 as one process's."""
    want = _single(run, S.config(), 2)
    got = _load(run, "sp_tp_s2")
    _close(_section(got, "grad/0/"), _section(want, "grad/0/"), **GRADS)
    _close(_section(got, "term/0/"), _section(want, "term/0/"), **TERMS)


def test_sp_eval_of_the_gnet_matches_one_process(run):
    """``evaluate`` with the G-net placed on the mesh (the prediction
    gathered before the resize and the metrics) against one process:
    1e-5, a1-a3 within one pixel of the sparsest image (as
    tests/test_torch_parallel_loop.py holds data-parallel eval)."""
    from gdn_tpu_torch.evaluate import evaluate
    from gdn_tpu_torch.train.steps import make_eval_forward

    cfg = S.config(eval_batch=4)
    samples = S.eval_samples()
    want = evaluate(cfg, make_eval_forward(cfg, R.nets(run["sd"], 2, cfg)[0]), samples,
                    verbose=False, device="cpu")
    got = _load(run, "sp_eval")
    pixel = 1.0 / min(int(((s["gt"] > 1e-3) & (s["gt"] < 80.0)).sum()) for s in samples)
    for k, v in want.items():
        if k.endswith("fps"):
            continue
        atol = max(1e-5, pixel) if k in ("a1", "a2", "a3") else 1e-5
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=1e-5, err_msg=k)


class _Mesh2D:
    """A (data, spatial) mesh as rank (d, s) sees it, without a process
    group: enough for the row rules."""

    mesh_dim_names = ("data", "spatial")

    def __init__(self, data, spatial, d=0, s=0):
        self._n, self._r = {"data": data, "spatial": spatial}, {"data": d, "spatial": s}

    def size(self, dim=None):
        return self._n[self.mesh_dim_names[dim]] if dim is not None else (
            self._n["data"] * self._n["spatial"])

    def get_local_rank(self, name=None):
        return self._r[name]

    def get_group(self, name=None):
        return None


def test_sp_batch_placement_splits_rows_and_height():
    """JAX's batch_sharding P("data", "spatial"): rank (1, 1) of a 2 x 4
    mesh holds batch rows [2, 4) and image rows [8, 12) of 16."""
    batch = {"x": torch.arange(4 * 16 * 3).view(4, 16, 3, 1)}
    mine = tmesh.shard_batch(batch, _Mesh2D(2, 4, 1, 1))["x"]
    assert torch.equal(mine, batch["x"][2:4, 4:8])
    stacked = tmesh.shard_stacked_batch({"x": batch["x"][None]}, _Mesh2D(2, 4, 1, 3))["x"]
    assert torch.equal(stacked[0], batch["x"][2:4, 12:16])
    with pytest.raises(AssertionError, match="not divisible"):
        tmesh.shard_batch({"x": torch.zeros(2, 6, 1, 1)}, _Mesh2D(2, 4))
    # a pipeline's rows at full height are cut to this rank's image rows
    mine = _Mesh2D(2, 4, 1, 2)
    rows = tmesh.local_batch({"x": batch["x"][2:4]}, mine, 4, height=16)["x"]
    assert torch.equal(rows, batch["x"][2:4, 8:12])
    # a loop's batch already cut to this rank's rows is kept
    assert tmesh.local_batch({"x": rows}, mine, 4, height=16)["x"] is rows
    with pytest.raises(ValueError, match="images of 6 rows"):
        tmesh.local_batch({"x": torch.zeros(2, 6, 1, 1)}, mine, 4, height=16)


def test_spatial_safe_cfg_is_the_jax_packages():
    from gdn_tpu import config as jcfg

    cfg = tcfg.kitti_config(**{"mesh.spatial_devices": 2})
    out = tsteps._spatial_safe_cfg(cfg, _Mesh2D(4, 2))
    assert not out.loss.use_pallas and not out.model.resize_conv_composed
    assert out.train == cfg.train
    assert tsteps._spatial_safe_cfg(cfg, None) is cfg
    jout = jsteps._spatial_safe_cfg(jcfg.kitti_config(), jmesh.create_mesh(8, spatial=2))
    assert (out.loss.use_pallas, out.model.resize_conv_composed) == (
        jout.loss.use_pallas, jout.model.resize_conv_composed)


def test_sp_refuses_heights_whose_levels_do_not_split():
    """The height rule is now the JAX package's (``_shard_tree``): the
    extent divides the height.  Heights whose levels split unevenly (NYU's
    228: 114 -> 57 rows at level 2) are accepted and run their unaligned
    levels gathered (tests/test_torch_split_rows.py); a height the extent
    does not divide is refused, by the batch placement too, and FSDP on a
    spatial mesh is accepted."""
    ax = tmesh.Axis(None, 2, 0)
    for h in (128, 228, 96, 64 + 32):
        tmesh.check_rows(h, ax)
    with pytest.raises(AssertionError, match="not divisible by mesh axis 'spatial'"):
        tmesh.check_rows(229, ax)
    with pytest.raises(AssertionError, match="not divisible"):
        tmesh.shard_batch({"x": torch.zeros(2, 229, 3, 1)}, _Mesh2D(1, 2))
    tcfg.MeshConfig(spatial_devices=2, fsdp=True)
