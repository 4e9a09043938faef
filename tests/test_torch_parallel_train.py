"""Data-parallel and FSDP training of the PyTorch port over two gloo
ranks on the CPU, against the JAX package's step on a 2-device mesh.

The ranks are spawned once for the file (``multihost.run_ranks``); they
run every scenario of ``torch_parallel_ranks.train_scenarios`` and
return their arrays through ``.npz`` files in a temporary directory.
The JAX side runs here, on the virtual CPU devices of conftest.py, with
the JAX package's own loss functions jitted on ``create_mesh(2)``.

The batches' masks hold twice as many valid pixels in rows 2-3 (rank 1)
as in rows 0-1 (rank 0), and every input carries continuous noise: with
the denominators left local, the ranks' mean would differ from the
global ratio and the gradients would miss JAX's by far more than the
bounds.  Bounds: loss terms atol 1e-4 / rtol 1e-3 (as
tests/test_torch_train.py holds the port to JAX), gradients rtol 5e-4 /
atol 1e-6 (tests/test_train.py's data-parallel bound); the port against
its own single-process run at the same gradient bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.parallel import mesh as jmesh
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch.checkpoint import params_from_flax
from gdn_tpu_torch.parallel.multihost import run_ranks

import torch_parallel_ranks as R

TERMS = dict(atol=1e-4, rtol=1e-3)
GRADS = dict(rtol=5e-4, atol=1e-6)
batches = R.batches


def _jcfg():
    return jcfg.Config(model=jcfg.ModelConfig(**R.SMALL), train=jcfg.TrainConfig(lr=1e-3))


def _to_flax(sd):
    """The port's state_dict as the JAX package's nested params (4-D
    kernels OIHW -> HWIO): the inverse of ``params_from_flax``."""
    tree = {}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        a = t.numpy()
        node[leaf] = jnp.asarray(np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a)
    return tree


def _jax_mesh_grads(stage, params, d_params, batch):
    """(terms, grads in the port's layout) of the JAX package's loss on
    a 2-device mesh: params replicated, the batch split on "data"."""
    cfg = _jcfg()
    mesh = jmesh.create_mesh(2)
    rep, data = jmesh.replicated(mesh), jmesh.batch_sharding(mesh)
    d_apply = JDtoD(cfg=cfg.model).apply
    if stage == 1:
        def f(p, b):
            return jax.value_and_grad(jsteps._stage1_loss, has_aux=True)(p, d_apply, b, cfg)

        (_, terms), grads = jax.jit(f, in_shardings=(rep, data))(params, batch)
    else:
        g_apply = JRtoD(cfg=cfg.model).apply

        def f(p, dp, b):
            return jax.value_and_grad(jsteps._stage2_loss, has_aux=True)(
                p, dp, g_apply, d_apply, b, cfg)

        (_, terms), grads = jax.jit(f, in_shardings=(rep, rep, data))(params, d_params, batch)
    return ({k: float(v) for k, v in terms.items()},
            params_from_flax(jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny nets: one thread here and in each rank (OMP_NUM_THREADS
    reaches the spawned ranks), where the default would oversubscribe
    the host's cores among pytest's workers."""
    old, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "2"  # run_ranks gives each of 2 ranks half
    yield
    torch.set_num_threads(old)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def run(tmp_path_factory, _few_threads):
    tmp = tmp_path_factory.mktemp("parallel_train")
    sd = R.weights()
    d, g = _to_flax(sd["d"]), _to_flax(sd["g"])
    host = batches()
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in host]
    inp = str(tmp / "inputs.pt")
    torch.save({"sd": sd, "batches": tb}, inp)
    run_ranks(R.train_scenarios, 2, (inp, str(tmp)), device_type="cpu", timeout=180)
    jax_ref = {s: _jax_mesh_grads(s, d if s == 1 else g, d, host[0]) for s in (1, 2)}
    return dict(dir=tmp, sd=sd, batches=tb, jax=jax_ref, single={})


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
    """The port's single-process run of the same scenario (computed once
    a scenario)."""
    key = (cfg, stage, n, tuple(sorted(kw.items())))
    if key not in run["single"]:
        state, terms, tap = R.run(cfg, stage, run["sd"], run["batches"][:n], None, **kw)
        run["single"][key] = {**R.terms_arrays(terms), **R.state_arrays(state, tap)}
    return run["single"][key]


def test_ranks_hold_different_valid_counts():
    b = batches()[0]
    per_rank = b["mask"].reshape(2, -1).sum(1)
    assert per_rank[1] >= 2 * per_rank[0]


@pytest.mark.parametrize("route", ["unfused", "fused"])
@pytest.mark.parametrize("stage", [1, 2])
def test_dp_terms_match_jax_mesh_step(run, stage, route):
    got = _section(_load(run, f"dp_s{stage}_{route}"), "term/0/")
    _close(got, run["jax"][stage][0], **TERMS)


@pytest.mark.parametrize("route", ["unfused", "fused"])
@pytest.mark.parametrize("stage", [1, 2])
def test_dp_grads_match_jax_mesh_step(run, stage, route):
    got = _section(_load(run, f"dp_s{stage}_{route}"), "grad/0/")
    want = {k: v for k, v in run["jax"][stage][1].items() if k in got}
    assert not stage == 2 or not any(k.startswith("decoder.") for k in got)
    _close(got, want, **GRADS)


def test_fsdp_stage2_grads_match_jax_mesh_step(run):
    got = _section(_load(run, "fsdp_s2"), "grad/0/")
    _close(got, {k: v for k, v in run["jax"][2][1].items() if k in got}, **GRADS)


@pytest.mark.parametrize("stage", [1, 2])
def test_fsdp_with_ema_matches_single_process(run, stage):
    """Two steps under FSDP (stage 1 also clipping, at a norm over the
    whole of each parameter): gradients, parameters and the EMA as one
    process's."""
    cfg = R.config(ema_decay=0.9, grad_clip=0.05 if stage == 1 else None)
    want = _single(run, cfg, stage, n=2)
    got = _load(run, f"fsdp_s{stage}")
    for prefix in ("grad/0/", "grad/1/", "param/", "ema/"):
        _close(_section(got, prefix), _section(want, prefix), **GRADS)
    _close(_section(got, "term/1/"), _section(want, "term/1/"), **TERMS)


@pytest.mark.parametrize("stage", [1, 2])
def test_fsdp_shards_what_jax_shards(run, stage):
    """Each rank holds half of every trained parameter that JAX's
    fsdp_spec shards at extent 2, and half of its two Adam moments;
    the others stay whole."""
    from gdn_tpu_torch.parallel.mesh import flax_shape

    for r in (0, 1):
        z = _load(run, f"fsdp_s{stage}.rank{r}")
        names = _section(z, "full/")
        assert names
        for k, full in names.items():
            jax_shards = bool(tuple(jmesh.fsdp_spec(flax_shape(run["sd"]["d" if stage == 1
                                                                       else "g"][k].shape), 2)))
            assert bool(z[f"sharded/{k}"]) == jax_shards, k
            want = full // 2 if jax_shards else full
            assert z[f"pbytes/{k}"] == want, k
            assert z[f"obytes/{k}"] == 2 * want, k


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_grad_accum_and_ema_match_single_process(run, mode):
    """grad_accum=2 with an EMA (JAX: tests/test_grad_accum.py): every
    micro-step reduced, the update on their mean; under FSDP the
    accumulator and the EMA are sharded like their parameters."""
    cfg = R.config(grad_accum=2, ema_decay=0.9)
    want = _single(run, cfg, 2, n=2)
    got = _load(run, "accum_ema" if mode == "dp" else "accum_ema_fsdp")
    assert "grad/1/" not in " ".join(got)  # one update from two micro-steps
    for prefix in ("grad/0/", "param/", "ema/"):
        _close(_section(got, prefix), _section(want, prefix), **GRADS)


def test_steps_per_call_matches_single_process(run):
    cfg = R.config(steps_per_call=2)
    want = _single(run, cfg, 1, n=2, stacked=True)
    got = _load(run, "multistep")
    for prefix in ("grad/0/", "grad/1/", "param/"):
        _close(_section(got, prefix), _section(want, prefix), **GRADS)
    _close(_section(got, "term/0/"), _section(want, "term/0/"), **TERMS)


def test_remat_changes_no_gradient_under_dp(run):
    _close(_section(_load(run, "remat"), "grad/0/"),
           _section(_load(run, "dp_s1_unfused"), "grad/0/"), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_parameter_without_gradient(run, mode):
    """A trainable parameter no loss term reaches: zero-filled before
    the reduction on every rank (no rank waits for it), reduced as zero,
    left unchanged by Adam; the other gradients are the plain step's."""
    got = _load(run, f"unused_{mode}")
    np.testing.assert_array_equal(got["unused"], np.ones((3, 5), np.float32))
    np.testing.assert_array_equal(got["grad/0/unused"], np.zeros((3, 5), np.float32))
    base = _section(_load(run, "dp_s1_unfused"), "grad/0/")
    _close({k: v for k, v in _section(got, "grad/0/").items() if k != "unused"}, base,
           **GRADS)
