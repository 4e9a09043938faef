"""The eval path of the PyTorch port against the JAX package, fp32 on
the CPU: the resizes it adds (gdn_tpu_torch/ops/resize.py), the eval
step and harness (gdn_tpu_torch/evaluate.py), the eval forward
(train/steps.py::make_eval_forward), validation and in-training eval
(train/loop.py), the synthetic eval split, and scripts/eval_torch.py.

- The eval step against ``gdn_tpu.evaluate.make_eval_step`` on the four
  cases of tests/test_parity_eval.py, with one analytic forward written
  in jnp and in torch (the protocol is under test, not a net): atol 1e-5
  / rtol 1e-5 on every per-image metric, that file's bound.
- ``evaluate()`` against the JAX ``evaluate()`` on a 5-image split (the
  pad path) and a mixed-resolution split, f32 and u16 GT wire: the same
  bound on the means, except that a1-a3 may differ by one pixel of the
  image with the fewest valid pixels.  They count pixels on either side
  of 1.25^k: the two forwards differ in the last bit, so a pixel that
  lies within rounding of the boundary can fall on either side (one
  such pixel shows in the u16 pad case).
- The harness's own contracts (device cache, byte gate, allocation
  failure, ``max_images`` at replay, ``save_preds`` names): equal
  results, compared exactly.
- The slice as a whole: a small G-net's flax weights, carried across by
  ``params_to_torch``, through the JAX ``evaluate(make_eval_forward())``
  and the port's, with and without flip TTA: rtol 1e-4 (the model
  tolerance of tests/test_torch_models.py).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu import evaluate as JE
from gdn_tpu import metrics as JM
from gdn_tpu.checkpoint import params_to_torch
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.ops import resize as jr
from gdn_tpu.train import loop as jloop
from gdn_tpu.train.steps import make_eval_forward as j_eval_forward
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch import evaluate as TE
from gdn_tpu_torch.checkpoint import init_params, latest_step, load_params, save_checkpoint
from gdn_tpu_torch.data.synthetic import SyntheticDataset, SyntheticEvalDataset
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.ops import resize as tr
from gdn_tpu_torch.train import loop as tloop
from gdn_tpu_torch.train.steps import make_eval_forward
from gdn_tpu_torch.utils.logging import MetricLogger

from torch_parallel_ranks import StubMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_RES = (32, 104)
TOL = dict(atol=1e-5, rtol=1e-5)
NET_HW = (32, 64)
SMALL = dict(image_size=NET_HW, enc_channels=(8, 16), dec_channels=(16, 8),
             use_pallas_gn=True)


def _cfgs(model=None, **eval_kw):
    """(JAX Config, port Config) of one eval setting."""
    model = model or dict(image_size=TRAIN_RES, dtype="float32", use_pallas=False)
    out = []
    for c in (jcfg, tcfg):
        out.append(c.Config(
            model=c.ModelConfig(**model), loss=c.LossConfig(use_pallas=False),
            data=c.DataConfig(dataset="synthetic", batch_size=2),
            train=c.TrainConfig(ckpt_dir=""),
            eval=c.EvalConfig(**{"batch_size": 2, **eval_kw})))
    return out


def _j_forward(params, rgb):
    return 2.0 + 60.0 * jax.nn.sigmoid(3.0 * jnp.mean(rgb, axis=-1, keepdims=True) - 1.0)


def _t_forward(rgb):
    return 2.0 + 60.0 * torch.sigmoid(3.0 * rgb.float().mean(dim=-1, keepdim=True) - 1.0)


def _pairs(seed, n, gt_shapes, cap, hw=TRAIN_RES):
    """(rgb at train size, GT at its own size) pairs, GT shapes cycled;
    GT has invalid (0) pixels and values beyond the cap."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rgb = rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32)
        gt = rng.uniform(0, cap * 1.3, (1, *gt_shapes[i % len(gt_shapes)])).astype(np.float32)
        gt[rng.uniform(size=gt.shape) < 0.15] = 0.0
        out.append({"rgb": rgb, "gt": gt})
    return out


def _metrics(d):
    return {k: d[k] for k in JM.METRIC_NAMES}


def _close(got, want, **tol):
    for k in JM.METRIC_NAMES:
        np.testing.assert_allclose(got[k], want[k], **(tol or TOL), err_msg=k)


def _one_pixel(samples, cap, crop):
    """The share of one pixel in the image with the fewest valid pixels."""
    counts = [(((s["gt"][0] > 1e-3) & (s["gt"][0] < cap))
               & JM.crop_mask(*s["gt"].shape[1:], crop)).sum() for s in samples]
    return 1.0 / min(counts)


def _close_thresholds(got, want, one_pixel):
    """TOL on the continuous metrics, one pixel on a1-a3."""
    for k in JM.METRIC_NAMES:
        atol = max(TOL["atol"], one_pixel) if k in ("a1", "a2", "a3") else TOL["atol"]
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=TOL["rtol"], err_msg=k)


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("hw,size", [
    ((32, 104), (75, 100)),  # H grows, W shrinks
    ((32, 104), (16, 52)),  # both shrink, exact 1/2
    ((375, 1242), (128, 416)),  # KITTI raw -> train size
    ((40, 60), (13, 59)),
])
def test_resize_bilinear_downsampling_matches_jax(hw, size):
    x = np.random.default_rng(0).uniform(0, 80, (2, *hw, 1)).astype(np.float32)
    got = tr.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    want = np.asarray(jr.resize_bilinear(jnp.asarray(x), size))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("hw,size", [
    ((375, 1242), (128, 416)), ((32, 104), (93, 311)), ((104, 32), (311, 93)),
    ((32, 104), (75, 100)), ((7, 5), (1, 1)), ((128, 416), (128, 416)),
])
def test_resize_nearest_matches_jax(hw, size):
    x = np.random.default_rng(1).uniform(0, 80, (2, *hw, 1)).astype(np.float32)
    got = tr.resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    want = np.asarray(jr.resize_nearest(jnp.asarray(x), size))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    bf = tr.resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(), size)
    assert bf.dtype == torch.bfloat16


# --------------------------------------------------------------- eval step

# (93, 311) is a non-integer scale from (32, 104); (75, 100) shrinks the width
@pytest.mark.parametrize("gt_shape,eval_kw", [
    ((93, 311), dict(cap=80.0, crop="garg")),
    ((64, 208), dict(cap=80.0, crop="eigen")),
    ((93, 311), dict(cap=80.0, crop="garg", median_scaling=True)),
    ((75, 100), dict(cap=10.0, crop="none")),
])
def test_eval_step_per_image_matches_jax(gt_shape, eval_kw):
    jc, tc = _cfgs(**eval_kw)
    samples = _pairs(2, 2, [gt_shape], tc.eval.cap)
    rgb = np.concatenate([s["rgb"] for s in samples])
    gt = np.concatenate([s["gt"] for s in samples])
    want = np.asarray(JE.make_eval_step(jc, _j_forward, gt_shape)({}, rgb, gt))
    step = TE.make_eval_step(tc, _t_forward, gt_shape, return_preds=True, device="cpu")
    got, preds = step(torch.from_numpy(rgb), torch.from_numpy(gt))
    assert got.shape == (len(JM.METRIC_NAMES), 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(preds.numpy(), np.asarray(_j_forward({}, rgb))[..., 0],
                               rtol=1e-6)


def test_eval_step_refuses_mesh_and_forward_refuses_quant():
    """A data mesh, refused until A10 was ported: the step builds, and the
    Evaluator takes each rank's rows of a batch that divides by the mesh
    and refuses one that does not (the JAX package's assertion)."""
    _, tc = _cfgs()
    TE.make_eval_step(tc, _t_forward, (8, 8), mesh=StubMesh(2), device="cpu")
    assert [TE.Evaluator(tc, _t_forward, mesh=StubMesh(2, r), device="cpu")._rows
            for r in (0, 1)] == [(0, 1), (1, 2)]
    _, odd = _cfgs(batch_size=3)
    with pytest.raises(AssertionError, match="divisible by the mesh size 2"):
        TE.Evaluator(odd, _t_forward, mesh=StubMesh(2), device="cpu")
    fake = type("Cfg", (), {"model": type("M", (), {"quant": "int8"})()})()
    with pytest.raises(ValueError, match="calibrated activation scales"):
        make_eval_forward(fake, torch.nn.Identity())


# ----------------------------------------------------------------- harness

@pytest.mark.parametrize("gt_wire", ["f32", "u16"])
@pytest.mark.parametrize("split", ["pad", "mixed"])
def test_evaluate_matches_jax(split, gt_wire):
    """5 images of one GT size (batch 2: a padded last batch) or 7 of
    three sizes interleaved (one group per size, out of dataset order)."""
    shapes = [(93, 311)] if split == "pad" else [(93, 311), (64, 208), (75, 100)]
    jc, tc = _cfgs(cap=80.0, crop="garg", gt_wire=gt_wire)
    samples = _pairs(3, 5 if split == "pad" else 7, shapes, 80.0)
    want = JE.evaluate(jc, {}, _j_forward, iter(samples), verbose=False)
    got = TE.evaluate(tc, _t_forward, iter(samples), verbose=False, device="cpu")
    _close_thresholds(got, want, _one_pixel(samples, 80.0, "garg"))
    assert got["fps"] > 0


def test_bf16_rgb_wire_is_bit_identical_with_a_bf16_model():
    model = dict(SMALL, dtype="bfloat16")
    _, auto = _cfgs(model, rgb_wire="auto")
    _, f32 = _cfgs(model, rgb_wire="f32")
    assert TE._wire_encoders(auto)[0] is not None and TE._wire_encoders(f32)[0] is None
    net = RtoDNet(auto.model)
    net.load_state_dict(init_params(auto.model, torch.Generator().manual_seed(0)))
    samples = _pairs(4, 3, [(40, 70)], 80.0, hw=NET_HW)
    res = [TE.evaluate(c, make_eval_forward(c, net), samples, verbose=False, device="cpu")
           for c in (auto, f32)]
    assert _metrics(res[0]) == _metrics(res[1])


def test_wire_encoders_refuse_unknown_formats():
    for kw in (dict(gt_wire="f16"), dict(rgb_wire="u8")):
        _, tc = _cfgs(**kw)
        with pytest.raises(ValueError, match="unknown"):
            TE.Evaluator(tc, _t_forward, device="cpu")


def test_device_cache_equals_host_fed():
    _, tc = _cfgs(cap=80.0, crop="garg")
    samples = _pairs(5, 7, [(93, 311), (75, 100)], 80.0)
    host = TE.evaluate(tc, _t_forward, samples, verbose=False, device="cpu")
    ev = TE.Evaluator(tc, _t_forward, device="cpu").cache_dataset(samples)
    assert ev.cached_images == 7 and ev.cached_bytes > 0
    cached = [ev.run(None, verbose=False) for _ in range(2)]
    assert _metrics(cached[0]) == _metrics(host) == _metrics(cached[1])
    via = TE.evaluate(tc, _t_forward, samples, verbose=False, device="cpu",
                      device_cache=True)
    assert _metrics(via) == _metrics(host)
    with pytest.raises(TypeError, match="re-iterable"):
        TE.evaluate(tc, _t_forward, iter(samples), device="cpu", device_cache=True)


def test_byte_gate_refuses_and_evaluate_stays_host_fed(monkeypatch, capsys):
    _, tc = _cfgs()
    samples = _pairs(6, 5, [(93, 311)], 80.0)
    host = TE.evaluate(tc, _t_forward, samples, verbose=False, device="cpu")
    ev = TE.Evaluator(tc, _t_forward, device="cpu")
    monkeypatch.setattr(TE.Evaluator, "CACHE_MAX_BYTES", 300_000)
    with pytest.raises(ValueError, match="exceeds"):
        ev.cache_dataset(samples)
    assert ev.cached_images == 0
    got = TE.evaluate(tc, _t_forward, samples, verbose=False, device="cpu",
                      device_cache=True)
    assert "stays host-fed" in capsys.readouterr().out
    assert _metrics(got) == _metrics(host)


def test_allocation_failure_while_caching_stays_host_fed(monkeypatch, capsys):
    """An upload that runs out of device memory drops the cache built so
    far and the pass is fed from the host, with the same metrics."""
    _, tc = _cfgs()
    samples = _pairs(7, 5, [(93, 311)], 80.0)
    host = TE.evaluate(tc, _t_forward, samples, verbose=False, device="cpu")
    real, calls = TE._upload, []

    def failing(t, device):
        calls.append(1)
        if len(calls) == 3:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)\nmore lines")
        return real(t, device)

    monkeypatch.setattr(TE, "_upload", failing)
    ev = TE.Evaluator(tc, _t_forward, device="cpu")
    assert not ev.cache_or_host_fed(samples)
    assert ev.cached_images == 0
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "out of memory" in out
    calls.clear()
    got = TE.evaluate(tc, _t_forward, samples, verbose=False, device="cpu",
                      device_cache=True)
    assert _metrics(got) == _metrics(host)


def test_max_images_is_honored_at_replay():
    _, tc = _cfgs()
    samples = _pairs(8, 7, [(93, 311), (75, 100)], 80.0)
    ev = TE.Evaluator(tc, _t_forward, device="cpu").cache_dataset(samples)
    for k in (1, 3, 4):
        host = TE.evaluate(tc, _t_forward, samples, max_images=k, verbose=False,
                           device="cpu")
        np.testing.assert_allclose(
            list(_metrics(ev.run(None, max_images=k, verbose=False)).values()),
            list(_metrics(host).values()), rtol=1e-6, atol=0)
    assert _metrics(ev.run(None, max_images=3, verbose=False)) != _metrics(
        ev.run(None, verbose=False))


def test_save_preds_follow_dataset_order(tmp_path):
    _, tc = _cfgs()
    samples = _pairs(9, 5, [(93, 311), (75, 100), (93, 311)], 80.0)
    TE.evaluate(tc, _t_forward, samples, verbose=False, device="cpu",
                save_preds=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [f"pred_{i:06d}.npy" for i in range(5)]
    for i, s in enumerate(samples):
        want = _t_forward(torch.from_numpy(s["rgb"]))[0, ..., 0].numpy()
        np.testing.assert_array_equal(np.load(tmp_path / f"pred_{i:06d}.npy"), want)


def test_run_without_cache_raises():
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="cache_dataset"):
        TE.Evaluator(tc, _t_forward, device="cpu").run(None)


def test_synthetic_eval_dataset_is_a_fixed_split():
    ds = SyntheticEvalDataset(n_images=3, height=16, width=32)
    a, b = list(ds), list(ds)
    assert len(ds) == 3 and len(a) == 3
    assert a[0]["rgb"].shape == (1, 16, 32, 3) and a[0]["gt"].shape == (1, 16, 32)
    assert all(isinstance(s["gt"], np.ndarray) for s in a)
    assert all(np.array_equal(x["gt"], y["gt"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["gt"], a[1]["gt"])
    d = SyntheticEvalDataset()
    assert (d.n_images, d.seed, d.height, d.width) == (32, 999, 128, 416)


def test_synthetic_eval_split_is_the_cpu_generators_draw():
    # the same split whatever device the protocol runs on: image i is
    # synthetic_batch under a CPU generator seeded by (999, i)
    from gdn_tpu_torch.data.synthetic import _image_seed, synthetic_batch

    for i, s in enumerate(SyntheticEvalDataset(n_images=2, height=16, width=32)):
        b = synthetic_batch(torch.Generator().manual_seed(_image_seed(999, i)), 1, 16, 32)
        np.testing.assert_array_equal(s["rgb"], b["rgb"].numpy())
        np.testing.assert_array_equal(s["gt"], b["depth"][..., 0].numpy())


def test_stage1_split_feeds_the_nearest_downsampled_gt():
    gt = np.random.default_rng(10).uniform(0, 80, (1, 75, 100)).astype(np.float32)
    (s,) = list(TE.Stage1Split([{"rgb": None, "gt": gt}], (32, 104)))
    want = np.asarray(jr.resize_nearest(jnp.asarray(gt[0]), (32, 104)))[None, ..., None]
    np.testing.assert_array_equal(s["rgb"], want)
    np.testing.assert_array_equal(s["gt"], gt)


# -------------------------------------------------------- the slice, whole

@pytest.fixture(scope="module")
def small_g_net():
    jm = jcfg.ModelConfig(**SMALL, dtype="float32")
    init = jax.jit(lambda x: JRtoD(cfg=jm).init(jax.random.PRNGKey(0), x))
    params = jax.tree_util.tree_map(
        np.asarray, init(np.zeros((1, *NET_HW, 3), np.float32))["params"])
    return params, {k: torch.from_numpy(np.array(v)) for k, v in params_to_torch(params).items()}


@pytest.mark.parametrize("flip_tta", [False, True])
def test_eval_of_a_g_net_matches_jax(small_g_net, flip_tta):
    params, sd = small_g_net
    model = dict(SMALL, dtype="float32")
    jc, tc = _cfgs(model, cap=80.0, crop="garg")
    samples = _pairs(11, 5, [(93, 190)], 80.0, hw=NET_HW)
    want = JE.evaluate(jc, params, j_eval_forward(jc, flip_tta=flip_tta), iter(samples),
                       verbose=False)
    net = RtoDNet(tc.model)
    net.load_state_dict(sd, strict=True)
    got = TE.evaluate(tc, make_eval_forward(tc, net, flip_tta=flip_tta), samples,
                      verbose=False, device="cpu")
    _close(got, want, rtol=1e-4, atol=1e-5)


def test_validation_terms_match_jax():
    """The port's _validate on a small D-net equals the JAX package's
    _val_terms on the same flax weights and batches (atol 1e-4 / rtol
    1e-3, tests/test_torch_train.py's loss bound)."""
    jm = jcfg.ModelConfig(**SMALL, dtype="float32")
    init = jax.jit(lambda x: JDtoD(cfg=jm).init(jax.random.PRNGKey(0), x))
    params = jax.tree_util.tree_map(
        np.asarray, init(np.zeros((1, *NET_HW, 1), np.float32))["params"])
    jc, tc = _cfgs(dict(SMALL, dtype="float32"))
    net = DtoDNet(tc.model)
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params_to_torch(params).items()})
    batches = list(zip(range(2), SyntheticDataset(2, *NET_HW, seed=3, device="cpu")))
    batches = [{k: v.numpy() for k, v in b.items()} for _, b in batches]
    logger = MetricLogger(prefix="v", stream=open(os.devnull, "w"))
    got = tloop._validate(tc, net, iter(batches), 5, logger, 0, torch.device("cpu"))
    sums = {}
    for b in batches:
        terms = jloop._val_terms(JDtoD(cfg=jm).apply, params, b, jc.loss,
                                 jc.model.max_depth, "depth")
        for k, v in terms.items():
            sums[k] = sums.get(k, 0.0) + float(v) / len(batches)
    assert set(got) == {f"val_{k}" for k in sums}
    for k, v in sums.items():
        np.testing.assert_allclose(got[f"val_{k}"], v, atol=1e-4, rtol=1e-3, err_msg=k)


def test_train_stage2_evaluates_and_keeps_the_best(tmp_path, monkeypatch):
    cfg = tcfg.kitti_config(**{
        "model.image_size": (16, 32), "model.enc_channels": (8, 16),
        "model.dec_channels": (16, 8), "model.dtype": "float32", "model.use_pallas_gn": True,
        "data.batch_size": 2, "train.steps_per_epoch": 1, "train.log_every": 1,
        "train.ckpt_dir": str(tmp_path), "eval.batch_size": 2})
    d_sd = init_params(cfg.model, torch.Generator().manual_seed(1), in_channels=1)
    split = list(SyntheticEvalDataset(n_images=3, height=16, width=32))
    calls, caches = [], []
    real_cache = TE.Evaluator.cache_dataset

    def counted(self, *a, **k):
        caches.append(1)
        return real_cache(self, *a, **k)

    monkeypatch.setattr(TE.Evaluator, "cache_dataset", counted)
    jsonl = str(tmp_path / "log.jsonl")
    logger = MetricLogger(prefix="stage2", jsonl_path=jsonl, stream=open(os.devnull, "w"))
    tloop.train_stage2(cfg, SyntheticDataset(2, 16, 32, device="cpu"), d_sd, epochs=2,
                       logger=logger, device="cpu",
                       val_iter=SyntheticDataset(2, 16, 32, seed=1, device="cpu"),
                       val_steps=1, eval_dataset=lambda: calls.append(1) or split,
                       eval_every=1)
    logger.close()
    recs = [json.loads(line) for line in open(jsonl)]
    evals = [r for r in recs if "eval_rmse" in r]
    assert [r["step"] for r in evals] == [1, 2]
    assert all(np.isfinite(r["eval_rmse"]) for r in evals)
    assert sum("val_total" in r for r in recs) == 2
    assert len(calls) == 1 and len(caches) == 1  # one upload; the second pass replays it
    best = [r for r in recs if "best_rmse" in r]
    assert best and best[0]["best_rmse"] == evals[0]["eval_rmse"]
    assert latest_step(str(tmp_path / "stage2_best")) == best[-1]["step"]
    RtoDNet(cfg.model).load_state_dict(load_params(str(tmp_path / "stage2_best")))


# ------------------------------------------------------------------ the CLI

def _script(name, *args):
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts", name), *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32",
        "--height", "32", "--width", "64"]


def test_eval_script_scores_what_train_script_wrote(tmp_path):
    common = TINY + ["--batch_size", "2", "--epochs", "1", "--steps_per_epoch", "1",
                     "--log_every", "1", "--ckpt_dir", str(tmp_path)]
    train = _load_script("train_torch")
    # stage 1 as train_torch.py --mode DtoD writes it (tests/test_torch_train.py
    # runs that mode), without its training time
    cfg = train.build_config(train.parse_args(["--mode", "DtoD", *common]))
    save_checkpoint(str(tmp_path / "stage1"), 0, tloop.stage1_state(cfg, "cpu"), cfg=cfg)
    train.main(["--mode", "RtoD", "--val_steps", "1", "--eval_every", "1",
                "--eval_max_images", "4", "--eval_batch", "2", *common])
    recs = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    assert any("val_total" in r for r in recs) and any("eval_rmse" in r for r in recs)
    assert latest_step(str(tmp_path / "stage2_best")) == 1
    out = _script("eval_torch.py", *TINY, "--ckpt_dir", str(tmp_path), "--best",
                  "--max_images", "4", "--eval_batch", "2", "--device_cache")
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("abs_rel=") and "rmse=" in last and "fps=" in last
    # stage 1 (the D-net's reconstruction) and the flip TTA, in-process
    mod = _load_script("eval_torch")
    s1 = mod.main(TINY + ["--ckpt_dir", str(tmp_path), "--stage", "1", "--max_images", "2",
                          "--gt_wire", "u16"])
    tta = mod.main(TINY + ["--ckpt_dir", str(tmp_path), "--flip_tta", "--max_images", "2",
                           "--median_scaling", "--crop", "eigen", "--cap", "50"])
    assert all(np.isfinite(r["rmse"]) for r in (s1, tta))
    cfg = mod.build_config(mod.parse_args(TINY + ["--cap", "50", "--crop", "eigen",
                                                  "--median_scaling", "--gt_wire", "u16"]))
    assert (cfg.eval.cap, cfg.eval.crop, cfg.eval.median_scaling, cfg.eval.gt_wire,
            cfg.eval.batch_size) == (50.0, "eigen", True, "u16", 8)


@pytest.mark.parametrize("flags,item", [
    (["--quantize", "int8", "--stage", "1"], "--stage 2 only"),
    (["--use_ema", "--pth", "w.pth"], "export_torch.py --use_ema"),
    (["--num_devices", "-1"], "num_devices must be >= 0"),
])
def test_eval_script_refuses_unported_flags(flags, item, capsys):
    mod = _load_script("eval_torch")
    argv = [a for a in TINY if a != "synthetic" and a != "--dataset"] + flags
    if "--dataset" not in flags:
        argv += ["--dataset", "synthetic"]
    with pytest.raises(SystemExit) as e:
        mod.parse_args(argv)
    assert e.value.code != 0
    assert item in capsys.readouterr().err


def test_eval_script_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        out = _script("eval_torch.py", "--dataset", "synthetic", "--ckpt_dir", str(tmp_path))
        assert out.returncode != 0 and "no CUDA device" in out.stderr
