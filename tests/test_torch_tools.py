"""The port's tools against the JAX package's, on the CPU: the numerics
guards (gdn_tpu_torch/utils/guards.py), the profiling hooks
(utils/profiling.py), TensorBoard logging (utils/logging.py), the
convergence protocol, profile_step and the demo (gdn_tpu_torch/demo.py,
scripts/*_torch.py) at tiny sizes.

- guards: NaN and Inf in a loss term and in a parameter are found and
  named, as ``gdn_tpu.utils.guards`` finds them on the same numpy
  values; ``train_stage1`` under ``check_numerics`` raises at the first
  non-finite step and trains as before on finite data.
- ``StepTimer``'s summary; ``trace`` writes a Chrome trace on the CPU.
- TensorBoard scalars are written and read back with tensorboard's
  ``EventAccumulator``.
- ``scripts/convergence_torch.py`` (1 seed, 3 steps a stage, 32x64,
  B=2, fp32) prints its per-seed line and the ``DONE`` line;
  ``scripts/profile_step_torch.py --device cpu --steps 2`` exits 0.
- The demo writes colorized maps at the inputs' sizes and a GIF, and its
  map equals ``gdn_tpu.ops.colormap.colorize_depth`` on the same depth;
  on a video (``imageio.v3.imiter`` stubbed) ``iter_frames`` and
  ``run_demo`` give the JAX package's frame names, PNGs and GIF frames.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu_torch import checkpoint as tckpt
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.data.synthetic import SyntheticDataset
from gdn_tpu_torch.train.loop import train_stage1
from gdn_tpu_torch.utils import guards as TG
from gdn_tpu_torch.utils.logging import MetricLogger
from gdn_tpu_torch.utils.profiling import StepTimer, annotate, kernel_times, summarize, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 64)


def _tiny(**train):
    return tcfg.Config(model=tcfg.ModelConfig(image_size=HW, enc_channels=(8, 16, 16, 32, 32),
                                              dec_channels=(32, 16, 16, 8, 8),
                                              group_norm_groups=4, dtype="float32"),
                       data=tcfg.DataConfig(batch_size=2, dataset="synthetic"),
                       train=tcfg.TrainConfig(ckpt_dir="", steps_per_epoch=2, log_every=1,
                                              **train))


# ------------------------------------------------------------------ guards

@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_guards_find_and_name_what_the_jax_guards_find(bad):
    jg = pytest.importorskip("gdn_tpu.utils.guards")
    rng = np.random.default_rng(0)
    terms = {"recon": np.float32(1.5), "grad": np.float32(bad), "total": np.float32(2.0)}
    params = {"encoder": {"conv0": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                                    "bias": np.zeros(4, np.float32)}},
              "head": {"kernel": rng.normal(size=(1, 1, 4, 1)).astype(np.float32)}}
    params["encoder"]["conv0"]["bias"][2] = bad
    t = lambda tree: {k: t(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))  # noqa
                      for k, v in tree.items()}
    for tree, named in ((terms, ["grad"]), (params, ["encoder.conv0.bias"])):
        assert bool(TG.check_finite(t(tree))) == bool(jg.check_finite_tree(tree)) is False
        assert TG.nonfinite_paths(t(tree)) == named
        assert len(jg.nonfinite_paths(tree)) == len(named)
        with pytest.raises(FloatingPointError, match=named[0]):
            TG.assert_finite(t(tree), "what")
    good = {"a": torch.ones(3), "b": {"c": torch.zeros(2, 2, dtype=torch.bfloat16)},
            "steps": torch.tensor(3)}
    assert bool(TG.check_finite(good)) and TG.nonfinite_paths(good) == []
    TG.assert_finite(good)


def test_guarded_step_checks_terms_every_call_and_params_every_deep_call():
    class State:
        def __init__(self):
            self.net = torch.nn.Linear(2, 2)

    calls = []

    def step(state, value):
        calls.append(value)
        return state, {"total": torch.tensor(value)}

    g = TG.GuardedStep(step, deep_every=2)
    s = State()
    g(s, 1.0)
    with torch.no_grad():
        s.net.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="params at call 2: bias"):
        g(s, 1.0)  # the deep check, every 2nd call
    with pytest.raises(FloatingPointError, match="loss terms at call 3: total"):
        g(s, float("inf"))


def test_check_numerics_guards_the_training_loop():
    cfg = _tiny(check_numerics=True)
    quiet = dict(logger=MetricLogger(stream=io.StringIO()), device="cpu", epochs=1)
    clean = train_stage1(cfg, SyntheticDataset(2, *HW, 80.0, seed=1, device="cpu"), **quiet)
    unguarded = train_stage1(_tiny(), SyntheticDataset(2, *HW, 80.0, seed=1, device="cpu"),
                             **quiet)
    for k, v in clean.net.state_dict().items():  # the guard changes nothing it passes
        assert torch.equal(v, unguarded.net.state_dict()[k]), k

    def poisoned():
        for i, b in enumerate(SyntheticDataset(2, *HW, 80.0, seed=1, device="cpu")):
            if i == 1:
                b = dict(b, depth=b["depth"].clone().fill_(float("nan")))
            yield b

    with pytest.raises(FloatingPointError, match="loss terms at call 2"):
        train_stage1(cfg, poisoned(), **quiet)


# ---------------------------------------------------------------- profiling

def test_step_timer_summary_leaves_out_the_warmup():
    t = StepTimer(warmup=2)
    assert t.summary() == {"steps": 0}
    for i in range(5):
        t.start()
        dt = t.stop({"x": torch.ones(2)} if i % 2 else None)
        assert dt >= 0
    s = t.summary()
    assert s["steps"] == 3 and s["p50_s"] <= s["p95_s"] and s["mean_s"] >= 0
    with pytest.raises(AssertionError):
        StepTimer().stop()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path), cuda=False) as prof:
        with annotate("my_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)
    ops = kernel_times(prof, cpu=True)
    assert "aten::mm" in ops and ops["aten::mm"][1] == 1
    assert kernel_times(prof) == {}  # no card rows on the CPU
    s = summarize({"k1": (3000.0, 6), "k2": (1000.0, 2)}, n_steps=2, wall_s=0.004, top=1)
    assert s["device_ms_per_step"] == 2.0 and s["launches_per_step"] == 4.0
    assert s["idle_share"] == 0.0 and s["top_kernels"] == [("k1", 1.5, 3.0)]


# ---------------------------------------------------------------- logging

def test_tensorboard_scalars_read_back(tmp_path):
    ea_mod = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    tb = str(tmp_path / "tb")
    lg = MetricLogger("stage1", str(tmp_path / "log.jsonl"), io.StringIO(), tensorboard_dir=tb)
    assert lg.tensorboard
    for step in (1, 2, 3):
        lg.log(step=step, total=1.0 / step, lr=1e-4, note="text")
    lg.close()
    acc = ea_mod.EventAccumulator(tb)
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["stage1/lr", "stage1/total"]
    got = [(e.step, e.value) for e in acc.Scalars("stage1/total")]
    assert [s for s, _ in got] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [1.0, 0.5, 1 / 3], rtol=1e-6)
    assert len(open(tmp_path / "log.jsonl").readlines()) == 3


def test_tensorboard_missing_warns_and_keeps_the_jsonl(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = MetricLogger("s", str(tmp_path / "log.jsonl"), io.StringIO(),
                      tensorboard_dir=str(tmp_path / "tb"))
    assert not lg.tensorboard
    lg.log(step=1, total=2.0)
    lg.close()
    assert "TensorBoard scalars disabled" in capsys.readouterr().err
    assert json.loads(open(tmp_path / "log.jsonl").read())["total"] == 2.0


def test_training_loop_logs_the_schedules_learning_rate(tmp_path):
    cfg = _tiny(schedule="cosine", warmup_steps=2, lr=1e-3, epochs=2)
    lg = MetricLogger("stage1", str(tmp_path / "log.jsonl"), io.StringIO())
    state = train_stage1(cfg, SyntheticDataset(2, *HW, 80.0, seed=1, device="cpu"),
                         logger=lg, device="cpu")
    lg.close()
    lrs = [json.loads(line)["lr"] for line in open(tmp_path / "log.jsonl")]
    # the LR of update t (0, 1, 2, 3) after a 2-step linear warmup, then cosine to 0
    want = [state.schedule(t) for t in range(4)]
    np.testing.assert_allclose(lrs, want, rtol=1e-12)
    assert want[0] == 0.0 and want[2] == pytest.approx(1e-3)


# ------------------------------------------------------------------ scripts

def _run(script, *args, timeout=600):
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts", script), *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_convergence_script_prints_its_lines_on_the_cpu():
    out = _run("convergence_torch.py", "--seeds", "0", "--steps", "3", "--batch_size", "2",
               "--eval_images", "2", "--device", "cpu", "--dtype", "float32")
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    seed, done = lines[-2], lines[-1]
    assert seed["seed"] == 0 and seed["seconds"] > 0
    jax_keys = {"abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "a1", "a2", "a3", "fps"}
    assert set(seed["metrics"]) == jax_keys
    assert done["DONE"] and done["seeds"] == [0] and done["a1_mean"] == seed["metrics"]["a1"]
    assert 0.0 <= done["a1_mean"] <= 1.0
    # --norm none, once refused, now builds the variant's protocol config
    spec = importlib.util.spec_from_file_location(
        "convergence_torch", os.path.join(REPO, "scripts", "convergence_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    args = script.parse_args(["--norm", "none", "--upsample", "deconv", "--multiscale"])
    cfg = script.protocol_config(args, 0)
    assert (cfg.model.norm, cfg.model.upsample, cfg.model.multiscale_heads) == (
        "none", "deconv", True)


def test_profile_step_script_on_the_cpu(tmp_path):
    out = _run("profile_step_torch.py", "--device", "cpu", "--dtype", "float32", "--steps",
               "2", "--batch_size", "2", "--height", "32", "--width", "64", "--top", "4",
               "--logdir", str(tmp_path))
    assert out.returncode == 0, out.stderr
    line = json.loads(next(x for x in out.stdout.splitlines() if x.startswith("{")))
    assert line["steps"] == 2 and line["ops_per_step"] > 0 and line["cpu_self_ms_per_step"] > 0
    assert "device_ms_per_step" not in line  # no device metric from a CPU run
    assert any(n.endswith(".json") for n in os.listdir(tmp_path))


def test_bench_scripts_on_the_cpu():
    out = _run("bench_torch.py", "--device", "cpu", "--dtype", "float32", "--batch_size", "1",
               "--height", "32", "--width", "64", "--iters", "1", "--warmup", "1")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(line["calls"]) == 3 and line["value"] == sorted(line["calls"])[1]
    assert line["unit"] == "imgs/sec" and len(line["load_avg_1m"]) == 3
    out = _run("bench_eval_torch.py", "--device", "cpu", "--dtype", "float32", "--images", "4",
               "--eval_batch", "2", "--gt_height", "40", "--gt_width", "120", "--height",
               "32", "--width", "64", "--device_cache", "--passes", "1")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["feeding"] == "device_cache" and line["images"] == 4 and line["fps"] > 0


# -------------------------------------------------------------------- demo

@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for name, hw in (("a", (40, 90)), ("b", (30, 50))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(d / f"{name}.png")
    return str(d)


def test_demo_writes_colorized_maps_and_a_gif(frames, tmp_path):
    jcm = pytest.importorskip("gdn_tpu.ops.colormap")
    from gdn_tpu_torch.demo import DepthPredictor, run_demo

    cfg = _tiny()
    sd = tckpt.init_params(cfg.model, torch.Generator().manual_seed(0))
    written = run_demo(cfg, sd, frames, str(tmp_path), gif="demo.gif", device="cpu")
    assert [os.path.basename(p) for p in written] == ["a_depth.png", "b_depth.png", "demo.gif"]
    pred = DepthPredictor(cfg, sd, device="cpu")
    for name, hw in (("a", (40, 90)), ("b", (30, 50))):
        rgb = np.asarray(Image.open(os.path.join(frames, f"{name}.png")).convert("RGB"))
        out = np.asarray(Image.open(tmp_path / f"{name}_depth.png"))
        assert out.shape == (2 * hw[0], hw[1], 3)  # the frame above its depth
        np.testing.assert_array_equal(out[:hw[0]], rgb)
        depth = pred(rgb)
        assert depth.shape == hw and np.isfinite(depth).all()
        np.testing.assert_array_equal(out[hw[0]:],
                                      jcm.colorize_depth(depth, cfg.model.max_depth, "magma"))
    gif = Image.open(tmp_path / "demo.gif")
    assert gif.n_frames == 2
    flip = run_demo(cfg, sd, os.path.join(frames, "b.png"), str(tmp_path / "f"),
                    side_by_side=False, flip_tta=True, device="cpu")
    assert np.asarray(Image.open(flip[0])).shape == (30, 50, 3)


def test_demo_script_on_the_cpu(frames, tmp_path):
    from gdn_tpu_torch.train.loop import stage1_state, stage2_state

    spec = importlib.util.spec_from_file_location(
        "demo_torch", os.path.join(REPO, "scripts", "demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    # a stage-2 checkpoint as scripts/train_torch.py writes it, untrained
    cfg = _tiny()
    d_sd = stage1_state(cfg, "cpu").net.state_dict()
    ckpt_dir = tmp_path / "ck"
    tckpt.save_checkpoint(str(ckpt_dir / "stage2"), 0, stage2_state(cfg, d_sd, "cpu"), cfg=cfg)
    written = demo.main(["--input", frames, "--output", str(tmp_path / "out"), "--gif", "d.gif",
                         "--model_dir", str(ckpt_dir), "--device", "cpu", "--dtype", "float32",
                         "--height", "32", "--width", "64"])
    assert len(written) == 3 and all(os.path.exists(p) for p in written)
    with pytest.raises(SystemExit, match="ema"):
        demo.main(["--input", frames, "--output", str(tmp_path / "out"), "--use_ema",
                   "--model_dir", str(ckpt_dir), "--device", "cpu"])


VIDEO_FRAMES = 3  # frames the stubbed reader yields, RGBA as imageio may give them


@pytest.fixture
def video(tmp_path, monkeypatch):
    """A video path whose frames come from a stub of imageio.v3.imiter
    (no mp4 encoder here to write a real one), the same frames every call."""
    iio = pytest.importorskip("imageio.v3")
    rng = np.random.default_rng(5)
    clip = rng.integers(0, 256, (VIDEO_FRAMES, 40, 90, 4), np.uint8)
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"")  # iter_frames takes the video branch for a file with its suffix
    read = []

    def imiter(p):
        read.append(str(p))
        yield from clip

    monkeypatch.setattr(iio, "imiter", imiter)
    return str(path), clip, read


def test_demo_video_frames_match_jax(video):
    jdemo = pytest.importorskip("gdn_tpu.demo")
    from gdn_tpu_torch.demo import iter_frames

    path, clip, read = video
    got, want = list(iter_frames(path)), list(jdemo.iter_frames(path))
    assert read == [path, path]
    assert [n for n, _ in got] == [n for n, _ in want] == [
        f"frame{i:05d}" for i in range(VIDEO_FRAMES)]
    for (_, a), (_, b), frame in zip(got, want, clip):
        assert a.shape == (40, 90, 3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, frame[..., :3])


@pytest.mark.parametrize("side_by_side", [True, False], ids=["stacked", "depth_only"])
def test_demo_video_run_matches_jax(video, tmp_path, side_by_side):
    """run_demo on a video: the JAX package's frame names, PNG count and
    GIF frame count, on the same frames and weights (the port's
    init_params carried into a flax tree)."""
    jax = pytest.importorskip("jax")
    jckpt = pytest.importorskip("gdn_tpu.checkpoint")
    jcfg = pytest.importorskip("gdn_tpu.config")
    jdemo = pytest.importorskip("gdn_tpu.demo")
    from gdn_tpu.models import RtoDNet as JRtoD
    from gdn_tpu_torch.demo import run_demo

    path, clip, _ = video
    cfg = _tiny()
    m = cfg.model
    jc = jcfg.Config(model=jcfg.ModelConfig(
        image_size=m.image_size, enc_channels=m.enc_channels, dec_channels=m.dec_channels,
        group_norm_groups=m.group_norm_groups, dtype="float32"))
    sd = tckpt.init_params(m, torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(JRtoD(cfg=jc.model).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, *HW, 3), np.float32))["params"]
    params = jckpt.params_from_torch(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), sd)
    kw = dict(gif="v.gif", side_by_side=side_by_side)
    got = run_demo(cfg, sd, path, str(tmp_path / "port"), device="cpu", **kw)
    want = jdemo.run_demo(jc, params, path, str(tmp_path / "jax"), **kw)
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want] == [
        *(f"frame{i:05d}_depth.png" for i in range(VIDEO_FRAMES)), "v.gif"]
    for a, b, frame in zip(got, want, clip):
        a, b = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        assert a.shape == b.shape == ((80 if side_by_side else 40), 90, 3)
        if side_by_side:
            np.testing.assert_array_equal(a[:40], frame[..., :3])
        # the colorized depth: the same map up to a colormap bin at a pixel
        assert np.abs(a[-40:].astype(int) - b[-40:]).mean() < 1.0
    assert Image.open(got[-1]).n_frames == Image.open(want[-1]).n_frames == VIDEO_FRAMES
