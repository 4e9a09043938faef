"""The model variants and stage 2's fused knobs under spatial parallelism,
at heights whose levels split unevenly, over two gloo ranks on the CPU
(``spatial_devices=2``), against the JAX package's steps on
``create_mesh(2, spatial=2)`` (``jax_mesh_ref``).

- The three variant nets of ``torch_split_ranks.VARIANTS``: at 18 rows
  (levels 18 -> 9 -> 5, split 9 / 9, 5 / 4 and 3 / 2: both stride-2
  convs have a second shard that starts on an odd row and run gathered,
  and the up-resizes 5 -> 9 and 9 -> 18 are not an exact 2x of the
  layout)
  the deconv + add + multi-scale + gelu net in stage 2 (the deconv's
  resize to the skip's size, the coarse heads on uneven rows, the latent
  term over uneven levels) and norm="none" + relu in stage 1; at 16 rows
  deconv_gn in stage 1, where every deconv runs on the rank's rows with
  its halo.
- ``fused_guidance`` and ``fused_encoders`` in stage 2 at 18 rows (the
  paired ladder's grouped conv and 2G-group GroupNorm on rows).
- 8 rows: shards of 4, thinner than SSIM's window (5 rows reflected) and
  than the gradient loss's 8-row pooling: those terms run gathered.

The ranks are spawned once for the file
(``torch_split_ranks.knob_scenarios``).  Bounds as PR 18's split tests.
Two mutants must miss JAX's gradients: a deconv halo that drops the row
of the rank below, and an uneven layout that runs a stride-2 conv on
rows whose shard starts on an odd row.  Without ranks: which sites of a
NYU net at 228 x 304 run on the rank's rows and which gather
(``parallel.spatial.site_plan``), and JAX's height rule.
"""

import os

import numpy as np
import pytest
import torch

from gdn_tpu.parallel import mesh as jmesh
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.parallel import spatial
from gdn_tpu_torch.parallel.mesh import Axis, check_rows
from gdn_tpu_torch.parallel.multihost import run_ranks

import jax_mesh_ref as J
import torch_split_ranks as S

TERMS = dict(atol=1e-4, rtol=1e-3)
GRADS = dict(rtol=5e-4, atol=1e-6)
KNOBS = {"fg": S.FG, "fe": S.FE}
# Seeds: the variant nets as tests/test_torch_split_model.py draws them
# (weights seed 5, input seed 3: under SP at 0.25x (deconv_add_ms_gelu),
# 0.05x (none_relu) and 0.47x (deconv_gn) of the gradient bound; input
# seeds 0-5 give 0.25-0.94x, 0.02-0.10x and 0.35-0.76x).  The default net
# (weights seed 3) at input seed 0: the fused knobs at 18 rows at
# 0.51x and 0.49x (seeds 0-4: 0.38-0.75x).  At 8 rows the port's own
# one-process stage-1 gradients miss JAX's on this mesh by 1.2-1.76x on
# input seeds 0-5 (fp32 noise of the small image), so the thin shards are
# held in stage 2, whose encoder gradients meet it (0.51x at seed 0).
VARIANT_SEEDS = dict(weights=5, inputs=3)
# (name, variant, rows, stage, train knobs)
CASES = [
    ("sp_deconv_add_ms_gelu", "deconv_add_ms_gelu", 18, 2, {}),
    ("sp_none_relu", "none_relu", 18, 1, {}),
    ("sp_deconv_gn", "deconv_gn", 16, 1, {}),
    ("sp_fg", "default", 18, 2, S.FG),
    ("sp_fe", "default", 18, 2, S.FE),
    ("sp_thin", "default", 8, 2, {}),
]
# (mutant case, the case whose JAX reference it must miss, mutant)
MUTANTS = [("sp_deconv_halo_mutant", "sp_deconv_gn", "deconv_halo"),
           ("sp_odd_start_mutant", "sp_none_relu", "odd_start")]


def _cases():
    out = {}
    for name, v, rows, stage, train in CASES:
        seed = VARIANT_SEEDS["inputs"] if v in S.VARIANTS else 0
        out[name] = dict(name=name, cfg=S.knob_config(S.VARIANTS.get(v), hw=(rows, 32),
                                                      spatial_=2, **train),
                         stage=stage, weights=v, batch=(rows, seed))
    for name, like, mutant in MUTANTS:
        out[name] = dict(out[like], name=name, mutant=mutant)
    out["sp_eval"] = dict(out["sp_deconv_add_ms_gelu"], name="sp_eval", eval=True)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    old, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "2"  # run_ranks gives each of 2 ranks half
    try:
        tmp = tmp_path_factory.mktemp("split_rows")
        sd = {v: S.knob_weights(m, VARIANT_SEEDS["weights"]) for v, m in S.VARIANTS.items()}
        sd["default"] = S.knob_weights()
        cases = _cases()
        host = {c["batch"]: S.batches_at((c["batch"][0], 32), seed=c["batch"][1])[0]
                for c in cases.values()}
        tb = {k: [{n: torch.from_numpy(v) for n, v in b.items()}] for k, b in host.items()}
        inp = str(tmp / "inputs.pt")
        torch.save({"sd": sd, "batches": tb, "cases": list(cases.values())}, inp)
        run_ranks(S.knob_scenarios, 2, (inp, str(tmp)), device_type="cpu", timeout=200)
        mesh = jmesh.create_mesh(2, spatial=2)
        jax_ref = {}
        for name, v, rows, stage, train in CASES:
            d, g = J.to_flax(sd[v]["d"]), J.to_flax(sd[v]["g"])
            jax_ref[name] = J.mesh_grads(stage, g if stage == 2 else d, d,
                                         host[cases[name]["batch"]], mesh,
                                         model=S.VARIANTS.get(v), train=train)
        yield dict(dir=tmp, jax=jax_ref, sd=sd, cases=cases)
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


def _grads(run, name, ref):
    g = _section(_load(run, name), "grad/0/")
    assert g
    return g, {k: v for k, v in run["jax"][ref][1].items() if k in g}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sp_knob_matches_jax_mesh_step(run, name):
    """Each case's terms and gradients on ``spatial=2`` against JAX's on
    its 2-device spatial mesh."""
    _close(_section(_load(run, name), "term/0/"), run["jax"][name][0], **TERMS)
    _close(*_grads(run, name, name), **GRADS)


@pytest.mark.parametrize("name,like,mutant", MUTANTS)
def test_sp_mutant_is_caught(run, name, like, mutant):
    """The mutation checks: a transposed conv whose halo drops the row
    below, and a stride-2 conv run on each rank's rows where the second
    shard starts on an odd row (9 rows split 5 / 4), miss JAX's
    gradients."""
    with pytest.raises(AssertionError):
        _close(*_grads(run, name, like), **GRADS)


def test_sp_eval_of_a_variant_gnet_at_uneven_rows_matches_one_process(run):
    """``evaluate`` with the deconv + add + multi-scale + gelu G-net at 18
    rows placed on the spatial mesh (the finest head on each rank's rows,
    the prediction gathered before the resize and the metrics) against
    one process: 1e-5, a1-a3 within one pixel of the sparsest image (as
    tests/test_torch_spatial.py holds the default net)."""
    from gdn_tpu_torch.evaluate import evaluate
    from gdn_tpu_torch.train.steps import make_eval_forward

    import torch_parallel_ranks as R

    cfg = S.knob_config(S.VARIANTS["deconv_add_ms_gelu"], hw=(18, 32))
    samples = S.eval_samples(hw=(18, 32))
    net = R.nets(run["sd"]["deconv_add_ms_gelu"], 2, cfg)[0]
    want = evaluate(cfg, make_eval_forward(cfg, net), samples, verbose=False, device="cpu")
    got = _load(run, "sp_eval")
    pixel = 1.0 / min(int(((s["gt"] > 1e-3) & (s["gt"] < 80.0)).sum()) for s in samples)
    for k, v in want.items():
        if k.endswith("fps"):
            continue
        atol = max(1e-5, pixel) if k in ("a1", "a2", "a3") else 1e-5
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=1e-5, err_msg=k)


# which row ops of a NYU net (228 x 304, 5 levels) run on each rank's rows
# at spatial=2: levels 228 -> 114 -> 57 -> 29 -> 15 -> 8
NYU_PLAN = [
    ("stem 7x7", True),
    ("down0 3x3/2 228->114", True), ("down0 3x3 114", True),
    ("down1 3x3/2 114->57", False), ("down1 3x3 57", True),
    ("down2 3x3/2 57->29", False), ("down2 3x3 29", True),
    ("down3 3x3/2 29->15", False), ("down3 3x3 15", True),
    ("down4 3x3/2 15->8", True), ("down4 3x3 8", True),
    ("up0 resize 8->15", False), ("up0 3x3 15", True),
    ("up1 resize 15->29", False), ("up1 3x3 29", True),
    ("up2 resize 29->57", False), ("up2 3x3 57", True),
    ("up3 resize 57->114", False), ("up3 3x3 114", True),
    ("up4 resize 114->228", True), ("up4 3x3 228", True),
]


def test_nyu_sites_that_run_on_rows_and_that_gather():
    """At NYU's 228 x 304 over 2 ranks (``torch.tensor_split`` layout):
    the stride-2 convs from 114 (57 / 57), 57 (29 / 28) and 29 (15 / 14)
    have a second shard that starts on an odd row, or whose output shard
    does not start at half its input's, and gather; from 228 and 15 they
    run on rows.  The up-resizes 8 -> 15, 15 -> 29 and 29 -> 57 are not
    2x, and 57 -> 114 doubles 29 / 28 into 57 / 57, not 58 / 56: they
    gather; 114 -> 228 runs on rows.  Every stride-1 conv holds its halo
    (the deconv branch's transposed convs follow the resizes' plan)."""
    assert spatial.site_plan(228, 5, 2) == NYU_PLAN
    deconv = spatial.site_plan(228, 5, 2, "deconv")
    assert [ok for _, ok in deconv] == [ok for _, ok in NYU_PLAN]
    assert spatial.level_rows(228, 5) == [228, 114, 57, 29, 15, 8]
    # KITTI's 128 x 416 splits evenly at every level: nothing gathers
    assert all(ok for _, ok in spatial.site_plan(128, 5, 2))


def test_sp_height_rule_is_the_jax_packages():
    """``check_rows`` asks only that the extent divide the height (JAX's
    ``_shard_tree``); NYU's 228 at spatial 2 is accepted, and so is FSDP
    on a spatial mesh."""
    ax = Axis(None, 2, 0)
    for h in (228, 18, 8, 96):
        check_rows(h, ax)
    with pytest.raises(AssertionError, match="not divisible"):
        check_rows(227, ax)
    tcfg.MeshConfig(spatial_devices=2, fsdp=True)
    assert spatial.row_sizes(57, 2) == [29, 28] and spatial.row_sizes(5, 4) == [2, 1, 1, 1]
