"""Resume, preemption, gradient accumulation and remat of the PyTorch
port, against the JAX package where it has the same function.

- ``grad_accum=2`` against ``optax.MultiSteps`` (the JAX package's
  steps): stage 1, and stage 2 with the frozen decoder, with clipping
  and an EMA, 4 micro-steps; loss terms on tests/test_torch_train.py's
  ``_compare`` bound (atol 1e-4, rtol 1e-3), the EMA and the parameters
  after the last update on the same bound.  The JAX suite's own cases
  (tests/test_grad_accum.py) on the port, and ``lr_schedule`` in update
  units against optax's.
- ``remat`` changes no gradient (fp32, CPU, atol 1e-6) in the unfused,
  fused and fusion configurations, and its backward runs the forward
  again.
- A resumed run equals an unbroken one bit for bit (parameters, EMA,
  Adam moments), also when it stopped in the middle of an accumulation.
- SIGTERM from the data iterator: the loop stops after the step in
  flight, checkpoints, and the restore continues.
- The command line: ``train_torch.py --resume``, ``eval_torch.py
  --use_ema`` and ``serve_torch.py --ckpt_dir``.
"""

import dataclasses
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu import config as jcfg
from gdn_tpu.data.synthetic import synthetic_batch as j_batch
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.train import state as jstate
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch import checkpoint as tckpt
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import params_from_flax, transfer_stage1_decoder
from gdn_tpu_torch.data.synthetic import SyntheticDataset
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train import state as tstate
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.train.loop import (
    stage1_state, stage2_state, train_stage1, train_stage2,
)
from gdn_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (16, 32)
SMALL = dict(image_size=HW, enc_channels=(8, 16), dec_channels=(16, 8),
             dtype="float32", use_pallas_gn=True)
FUSED = dict(use_pallas_convgn_bt=True, use_pallas_convgn_s2=True,
             use_pallas_fusion_bt=True)
FUSION = dict(use_pallas_fusion=True)
CONFIGS = {"unfused": {}, "fused": FUSED, "fusion": FUSION}


def _compare(jax_traj, port_traj):
    """tests/test_torch_train.py's bound on the loss terms."""
    for t, (jt, pt) in enumerate(zip(jax_traj, port_traj)):
        assert set(jt) == set(pt)
        for k in jt:
            np.testing.assert_allclose(pt[k], jt[k], atol=1e-4, rtol=1e-3,
                                       err_msg=f"micro-step {t} term {k}")


def _flat(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _batches(seed, n):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append({k: np.asarray(v) for k, v in j_batch(sub, 2, *HW, 80.0).items()})
    return out


def _tb(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


# ------------------------------------------------- grad_accum against optax

ACCUM_TRAIN = dict(lr=1e-3, steps_per_epoch=4, ckpt_dir="", grad_accum=2, grad_clip=0.5,
                   ema_decay=0.9, warmup_steps=2)


@pytest.mark.parametrize("stage", [1, 2])
def test_grad_accum_follows_optax_multisteps(stage):
    jc = jcfg.Config(model=jcfg.ModelConfig(**SMALL), train=jcfg.TrainConfig(**ACCUM_TRAIN))
    tc = tcfg.Config(model=tcfg.ModelConfig(**SMALL), train=tcfg.TrainConfig(**ACCUM_TRAIN))
    h, w = HW
    js_d = jstate.create_state(JDtoD(cfg=jc.model), (1, h, w, 1), jc.train, 4)
    d_net = DtoDNet(tc.model)
    d_net.load_state_dict(_flat(js_d.params))
    if stage == 1:
        js, net = js_d, d_net
        ts = tstate.TrainState(net, tc.train, 4)
        jstep, tstep = jsteps.make_stage1_step(jc), tsteps.make_stage1_step(tc)
    else:
        js = jstate.create_state(JRtoD(cfg=jc.model), (1, h, w, 3), jc.train, 4,
                                 freeze_decoder=True)
        g_sd = transfer_stage1_decoder(_flat(js.params), _flat(js_d.params))
        js = js.replace(params={**js.params, "decoder": jax.tree_util.tree_map(
            jax.numpy.copy, js_d.params["decoder"])},
            ema_params={**js.ema_params, "decoder": jax.tree_util.tree_map(
                jax.numpy.copy, js_d.params["decoder"])})
        net = RtoDNet(tc.model)
        net.load_state_dict(g_sd)
        d_net.requires_grad_(False)
        ts = tstate.TrainState(net, tc.train, 4, freeze_decoder=True)
        js2, ts2 = jsteps.make_stage2_step(jc), tsteps.make_stage2_step(tc)
        jstep = lambda s, b: js2(s, js_d.params, b)  # noqa: E731
        tstep = lambda s, b: ts2(s, d_net, b)  # noqa: E731
    p0 = {k: v.clone() for k, v in net.state_dict().items()}
    traj = ([], [])
    for i, b in enumerate(_batches(3 + stage, 4)):
        js, jt = jstep(js, b)
        ts, tt = tstep(ts, _tb(b))
        traj[0].append({k: float(v) for k, v in jt.items()})
        traj[1].append({k: float(v) for k, v in tt.items()})
        if i == 0:  # accumulation only: parameters and EMA untouched
            assert all(torch.equal(v, p0[k]) for k, v in net.state_dict().items())
            assert all(torch.equal(v, p0[k]) for k, v in ts.ema.items())
    _compare(*traj)
    assert ts.step == int(js.step) == 4 and ts.updates == 2
    for name, jtree, tree in (("params", js.params, net.state_dict()),
                              ("ema", js.ema_params, ts.ema)):
        want = _flat(jtree)
        for k, v in tree.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4, rtol=1e-3,
                                       err_msg=f"{name} {k}")
    if stage == 2:  # the frozen decoder never moved
        for k, v in net.decoder.state_dict().items():
            assert torch.equal(v, p0[f"decoder.{k}"]), k


def _tiny(**train):
    return tcfg.Config(model=tcfg.ModelConfig(**SMALL),
                       data=tcfg.DataConfig(dataset="synthetic", batch_size=2),
                       train=tcfg.TrainConfig(**{"lr": 1e-3, "steps_per_epoch": 10,
                                                 "ckpt_dir": "", "log_every": 100,
                                                 **train}))


def _tbatch(seed):
    return next(iter(SyntheticDataset(2, *HW, 80.0, seed=seed, device="cpu")))


def test_accum_micro_step_is_identity_then_applies():
    """tests/test_grad_accum.py's case on the port: the same batch twice
    under grad_accum=2 is one plain step."""
    s_acc = stage1_state(_tiny(grad_accum=2), "cpu")
    s_ref = stage1_state(_tiny(), "cpu")
    step_acc = tsteps.make_stage1_step(_tiny(grad_accum=2))
    step_ref = tsteps.make_stage1_step(_tiny())
    b0 = _tbatch(0)
    p0 = {k: v.clone() for k, v in s_acc.net.state_dict().items()}
    step_acc(s_acc, b0)
    assert all(torch.equal(v, p0[k]) for k, v in s_acc.net.state_dict().items())
    step_acc(s_acc, b0)
    step_ref(s_ref, b0)
    ref = s_ref.net.state_dict()
    for k, v in s_acc.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-7)


def test_accum_ema_updates_only_on_apply():
    d = 0.5
    cfg = _tiny(grad_accum=2, ema_decay=d)
    state = stage1_state(cfg, "cpu")
    step = tsteps.make_stage1_step(cfg)
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    step(state, _tbatch(0))
    assert all(torch.equal(v, ema0[k]) for k, v in state.ema.items())
    step(state, _tbatch(1))
    for k, p in state.net.named_parameters():
        np.testing.assert_allclose(state.ema[k].numpy(),
                                   (d * ema0[k] + (1 - d) * p.detach()).numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_accum_with_frozen_decoder_and_clip():
    cfg = _tiny(grad_accum=2, grad_clip=1.0)
    gen = torch.Generator().manual_seed(0)
    net = DtoDNet(cfg.model)
    net.load_state_dict(tckpt.init_params(cfg.model, gen, in_channels=1))
    state = tstate.TrainState(net, cfg.train, 10, freeze_decoder=True)
    step = tsteps.make_stage1_step(cfg)
    dec0 = {k: v.clone() for k, v in net.decoder.state_dict().items()}
    enc0 = {k: v.clone() for k, v in net.encoder.state_dict().items()}
    step(state, _tbatch(0))
    step(state, _tbatch(1))
    assert all(torch.equal(v, dec0[k]) for k, v in net.decoder.state_dict().items())
    assert any(not torch.equal(v, enc0[k]) for k, v in net.encoder.state_dict().items())


@pytest.mark.parametrize("accum", [2, 3])
@pytest.mark.parametrize("warmup", [0, 4])
@pytest.mark.parametrize("schedule", ["step", "cosine", "constant"])
def test_lr_schedule_with_grad_accum_matches_optax(schedule, warmup, accum):
    kw = dict(lr=1e-3, schedule=schedule, decay_epochs=2, decay_gamma=0.5, epochs=4,
              warmup_steps=warmup, grad_accum=accum)
    spe = 6
    want = jstate.lr_schedule(jcfg.TrainConfig(**kw), spe)
    got = tstate.lr_schedule(tcfg.TrainConfig(**kw), spe)
    ts = range(0, 3 * 2 * spe + 1)
    # rtol 1e-5: optax evaluates in float32, the port in float64
    np.testing.assert_allclose([got(t) for t in ts], [float(want(t)) for t in ts],
                               rtol=1e-5, atol=1e-12)


# ------------------------------------------------------------------- remat

def _grads(cfg, stage, batch):
    gen = torch.Generator().manual_seed(5)
    d_net = DtoDNet(cfg.model)
    d_net.load_state_dict(tckpt.init_params(cfg.model, gen, in_channels=1))
    if stage == 1:
        net = d_net
        terms = tsteps._stage1_loss(net, batch, cfg)
    else:
        net = RtoDNet(cfg.model)
        net.load_state_dict(transfer_stage1_decoder(
            tckpt.init_params(cfg.model, gen, in_channels=3), d_net.state_dict()))
        net.decoder.requires_grad_(False)
        d_net.requires_grad_(False)
        terms = tsteps._stage2_loss(net, d_net, batch, cfg)
    terms["total"].backward()
    return ({k: v.detach() for k, v in terms.items()},
            {k: p.grad for k, p in net.named_parameters() if p.requires_grad})


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_remat_changes_no_gradient(config, stage):
    model = tcfg.ModelConfig(**SMALL, **CONFIGS[config])
    batch = _tbatch(2)
    (t0, g0), (t1, g1) = [
        _grads(tcfg.Config(model=model, train=tcfg.TrainConfig(remat=r)), stage, batch)
        for r in (False, True)]
    for k in t0:
        assert float(t1[k]) == float(t0[k]), k
    assert g0.keys() == g1.keys()
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("stage", [1, 2])
def test_remat_runs_the_trained_forward_again_in_the_backward(stage, monkeypatch):
    """Under remat the trained net's encoder runs twice a step (forward,
    then the recompute in the backward); the frozen D-net of stage 2
    runs once, outside the checkpoint."""
    runs = {"trained": 0, "frozen": 0}
    for remat, want in ((False, 1), (True, 2)):
        cfg = tcfg.Config(model=tcfg.ModelConfig(**SMALL), train=tcfg.TrainConfig(remat=remat))
        d_net = DtoDNet(cfg.model)
        net = d_net if stage == 1 else RtoDNet(cfg.model)
        runs.update(trained=0, frozen=0)
        net.encoder.register_forward_hook(
            lambda *a: runs.__setitem__("trained", runs["trained"] + 1))
        if stage == 2:
            d_net.encoder.register_forward_hook(
                lambda *a: runs.__setitem__("frozen", runs["frozen"] + 1))
            d_net.requires_grad_(False)
            terms = tsteps._stage2_loss(net, d_net, _tbatch(0), cfg)
        else:
            terms = tsteps._stage1_loss(net, _tbatch(0), cfg)
        assert runs["trained"] == 1
        terms["total"].backward()
        assert runs["trained"] == want
        assert runs["frozen"] == (0 if stage == 1 else 1)


# ------------------------------------------------------------------ resume

def _snapshot(state):
    """Parameters, EMA, Adam moments and counts, copied."""
    opt = {i: {k: v.clone() for k, v in st.items()}
           for i, st in enumerate(state.optimizer.state[p] for p in state.params)}
    return dict(params={k: v.clone() for k, v in state.net.state_dict().items()},
                ema={k: v.clone() for k, v in (state.ema or {}).items()}, opt=opt,
                acc={k: v.clone() for k, v in (state.acc or {}).items()},
                counts=(state.step, state.updates))


def _bit_equal(a, b):
    assert a["counts"] == b["counts"]
    for key in ("params", "ema", "acc"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert a["opt"].keys() == b["opt"].keys()
    for i in a["opt"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["opt"][i][k], b["opt"][i][k]), (i, k)


RESUME_CASES = {  # stage, grad_accum, steps before the stop, async write
    "stage1": (1, 1, 2, False),
    "stage1_accum_mid": (1, 2, 3, False),
    "stage2_accum_mid_async": (2, 2, 3, True),
}


@pytest.mark.parametrize("name", list(RESUME_CASES))
def test_resumed_run_equals_unbroken_run(tmp_path, name):
    stage, accum, k, use_async = RESUME_CASES[name]
    n = 6
    cfg = _tiny(grad_accum=accum, ema_decay=0.9, grad_clip=1.0, steps_per_epoch=1,
                async_ckpt=use_async, warmup_steps=2)
    quiet = dict(logger=MetricLogger(stream=io.StringIO()), device="cpu")
    d_sd = tckpt.init_params(cfg.model, torch.Generator().manual_seed(9), in_channels=1)

    def run(cfg, epochs, state=None, skip=0):
        data = SyntheticDataset(2, *HW, 80.0, seed=4, device="cpu")
        data.seek(skip)
        if stage == 1:
            return train_stage1(cfg, data, epochs=epochs, state=state, **quiet)
        return train_stage2(cfg, data, d_sd, epochs=epochs, state=state, **quiet)

    unbroken = _snapshot(run(cfg, n))
    ck = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                            ckpt_dir=str(tmp_path)))
    run(ck, k)
    stage_dir = str(tmp_path / f"stage{stage}")
    assert tckpt.latest_step(stage_dir) == k
    assert tckpt.load_loader_state(stage_dir) == {"step": k}
    fresh = stage1_state(cfg, "cpu") if stage == 1 else stage2_state(cfg, d_sd, "cpu")
    restored = tckpt.restore_checkpoint(stage_dir, fresh)
    assert (restored.step, restored.updates) == (k, k // accum)
    if accum > 1:  # stopped mid-accumulation: the buffers hold one micro-step
        assert any(bool(v.abs().sum() > 0) for v in restored.acc.values())
    resumed = _snapshot(run(cfg, n - k, state=restored, skip=restored.step))
    _bit_equal(resumed, unbroken)


@pytest.mark.parametrize("stage", [1, 2])
def test_sigterm_checkpoints_and_the_restore_continues(tmp_path, stage, capsys):
    """The port's counterpart of tests/test_train.py's preemption test."""
    cfg = _tiny(steps_per_epoch=50, ckpt_dir=str(tmp_path), ema_decay=0.9)
    d_sd = tckpt.init_params(cfg.model, torch.Generator().manual_seed(9), in_channels=1)

    def preempting_iter():
        for i, b in enumerate(iter(SyntheticDataset(2, *HW, 80.0, seed=3, device="cpu"))):
            if i == 2:
                signal.raise_signal(signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    quiet = dict(logger=MetricLogger(stream=io.StringIO()), device="cpu")
    val = dict(val_iter=SyntheticDataset(2, *HW, 80.0, seed=5, device="cpu"), val_steps=1)
    if stage == 1:
        state = train_stage1(cfg, preempting_iter(), epochs=2, **quiet, **val)
    else:
        state = train_stage2(cfg, preempting_iter(), d_sd, epochs=2, **quiet, **val,
                             eval_dataset=lambda: pytest.fail("eval after preemption"))
    assert signal.getsignal(signal.SIGTERM) == before
    assert state.step == 3  # the step in flight when the signal came was finished
    out = capsys.readouterr().out
    assert ("[train] preempted: checkpoint saved at step 3; resume with --resume"
            in out)
    stage_dir = str(tmp_path / f"stage{stage}")
    assert sorted(os.listdir(stage_dir)) == ["3.pt", "config.json"]
    fresh = stage1_state(cfg, "cpu") if stage == 1 else stage2_state(cfg, d_sd, "cpu")
    restored = tckpt.restore_checkpoint(stage_dir, fresh)
    assert restored.step == 3
    _bit_equal(_snapshot(restored), _snapshot(state))
    data = SyntheticDataset(2, *HW, 80.0, seed=3, device="cpu")
    data.seek(restored.step)
    cont = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps_per_epoch=2,
                                                              ckpt_dir=""))
    if stage == 1:
        resumed = train_stage1(cont, data, epochs=1, state=restored, **quiet)
    else:
        resumed = train_stage2(cont, data, d_sd, epochs=1, state=restored, **quiet)
    assert resumed.step == 5


# ---------------------------------------------------------------- the CLI

TINY = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32",
        "--height", "16", "--width", "32"]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_script_resume_continues_the_step_count(tmp_path, capsys):
    train = _load_script("train_torch")
    common = [*TINY, "--batch_size", "1", "--epochs", "2", "--steps_per_epoch", "2",
              "--log_every", "1", "--ckpt_dir", str(tmp_path), "--grad_accum", "2"]
    first = train.main(["--mode", "DtoD", *common])
    assert first.step == 4 and first.updates == 2
    # the saved config is adopted: no --height/--width on the resumed run
    resumed = train.main(["--mode", "DtoD", *[a for a in common if a not in (
        "--height", "16", "--width", "32")], "--resume"])
    out = capsys.readouterr().out
    assert "resumed stage 1 at step 4" in out
    assert "stage 1 finished at step 8" in out
    assert resumed.step == 8 and resumed.updates == 4
    assert sorted(os.listdir(tmp_path / "stage1")) == ["4.pt", "6.pt", "8.pt", "config.json"]
    recs = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    assert [r["step"] for r in recs] == list(range(1, 9))


@pytest.fixture(scope="module")
def trained_with_ema(tmp_path_factory):
    """Stage 1 without an EMA, then stage 2 with one, at a non-default
    image size, through train_torch.py."""
    root = tmp_path_factory.mktemp("ck")
    train = _load_script("train_torch")
    common = [*TINY, "--batch_size", "1", "--epochs", "1", "--steps_per_epoch", "2",
              "--log_every", "1", "--ckpt_dir", str(root), "--lr", "1e-2"]
    train.main(["--mode", "DtoD", *common])
    train.main(["--mode", "RtoD", "--ema_decay", "0.5",
                *[a for a in common if a not in ("--height", "16", "--width", "32")]])
    return root


def test_eval_script_use_ema(trained_with_ema, capsys):
    ev = _load_script("eval_torch")
    base = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32",
            "--ckpt_dir", str(trained_with_ema), "--max_images", "2", "--eval_batch", "2"]
    plain = ev.main(base)
    ema = ev.main([*base, "--use_ema"])
    assert "(EMA)" in capsys.readouterr().out
    assert all(np.isfinite(v) for v in ema.values())
    assert ema["rmse"] != plain["rmse"]
    with pytest.raises(SystemExit, match="no 'ema'"):
        ev.main([*base, "--stage", "1", "--use_ema"])


def test_serve_script_from_a_checkpoint_dir(trained_with_ema):
    """serve_torch.py --ckpt_dir serves stage2/ at the size its
    config.json gives (16x32, not the preset's 128x416), with its EMA."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "serve_torch.py"),
         "--ckpt_dir", str(trained_with_ema), "--use_ema", "--device", "cpu",
         "--dtype", "float32", "--port", "0", "--serve_batch", "2", "--max_wait_ms", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline:
            lines.append(proc.stdout.readline())
            if "serving on" in lines[-1] or proc.poll() is not None:
                break
        text = "".join(lines)
        assert "serving on" in lines[-1], text + proc.stdout.read()
        assert "warming up the serving path (16x32)" in text
        assert "adopted model config" in text
        port = int(lines[-1].split("http://127.0.0.1:")[1].split(" ")[0])
        rgb = np.random.default_rng(0).integers(0, 255, (16, 32, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            depth = np.load(io.BytesIO(r.read()))
        assert depth.shape == (16, 32) and np.isfinite(depth).all()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def test_serve_script_use_ema_needs_a_checkpoint_dir(capsys):
    serve = _load_script("serve_torch")
    with pytest.raises(SystemExit):
        serve.parse_args(["--init_random", "--use_ema"])
    assert "--ckpt_dir" in capsys.readouterr().err
