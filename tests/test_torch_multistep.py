"""Multistep training (``TrainConfig.steps_per_call``) of the PyTorch port
against the JAX package: ``make_stage{1,2}_multistep`` and the epoch
loop that feeds them K batches a call.

- K=2 from the same flax-initialized weights and the same
  ``synthetic_batch`` arrays (plus continuous noise on the depth, so
  that no L1 term sits on a tie), fp32, on the CPU: the port's multistep
  equals two of its single steps bit for bit (parameters, EMA, Adam
  moments, the accumulator, the counts), and its terms are held to two
  JAX single steps and to the JAX multistep (``jax.lax.scan``) at
  tests/test_torch_train.py's trajectory bound (atol 1e-4, rtol 1e-3):
  stage 1 with an EMA, and stage 2 with the frozen decoder, an EMA and
  ``grad_accum=2`` with a clip.
- The loop: the JAX package's divisibility refusal, its log cadence and
  images/s on a stepped clock, and ``train_stage{1,2}`` choosing the
  multistep.
- ``scripts/train_torch.py --steps_per_call 2``: ``--resume`` continues
  bit for bit, and ``--fused_guidance`` trains both stages.
"""

import dataclasses
import functools
import importlib.util
import io
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu.checkpoint import params_from_torch
from gdn_tpu.checkpoint import transfer_stage1_decoder as j_transfer
from gdn_tpu.data.synthetic import synthetic_batch as j_batch
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.train import loop as jloop
from gdn_tpu.train import state as jstate
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch import checkpoint as tckpt
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import params_from_flax
from gdn_tpu_torch.data.synthetic import SyntheticDataset
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train import loop as tloop
from gdn_tpu_torch.train import state as tstate
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (16, 32)
K = 2
SMALL = dict(image_size=HW, enc_channels=(8, 16), dec_channels=(16, 8),
             dtype="float32", use_pallas_gn=True)
# name -> (stage, TrainConfig fields)
CASES = {
    "stage1_ema": (1, dict(ema_decay=0.5)),
    "stage2_accum_clip_ema": (2, dict(grad_accum=2, grad_clip=0.5, ema_decay=0.9)),
}


def _cfgs(train):
    t = dict(dict(lr=1e-3, steps_per_epoch=4, ckpt_dir="", steps_per_call=K), **train)
    return (jcfg.Config(model=jcfg.ModelConfig(**SMALL), train=jcfg.TrainConfig(**t)),
            tcfg.Config(model=tcfg.ModelConfig(**SMALL), train=tcfg.TrainConfig(**t)))


def _batches(seed):
    key, out = jax.random.PRNGKey(seed), []
    for i in range(K):
        key, sub = jax.random.split(key)
        b = {k: np.asarray(v) for k, v in j_batch(sub, 2, *HW, 80.0).items()}
        noise = np.random.default_rng(seed + i).uniform(0, 0.05, b["depth"].shape)
        b["depth"] = (b["depth"] + noise).astype(np.float32)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def _init(net_cls, channels, seed):
    """A flax parameter tree (numpy) of the small net: the port's
    ``init_params`` draw, carried by ``params_from_torch`` into the
    template of ``jax.eval_shape`` (no compiled init)."""
    jc, tc = _cfgs({})
    x = jax.ShapeDtypeStruct((1, *HW, channels), jnp.float32)
    tmpl = jax.eval_shape(lambda x: net_cls(cfg=jc.model).init(jax.random.PRNGKey(0), x),
                          x)["params"]
    sd = tckpt.init_params(tc.model, torch.Generator().manual_seed(seed),
                           in_channels=channels)
    return jax.tree_util.tree_map(np.asarray, params_from_torch(tmpl, sd))


def _tb(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _flat(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _snapshot(state):
    opt = {i: {k: v.clone() for k, v in state.optimizer.state[p].items()}
           for i, p in enumerate(state.params)}
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
    for i in a["opt"]:
        for k in a["opt"][i]:
            assert torch.equal(a["opt"][i][k], b["opt"][i][k]), (i, k)


def _floats(terms):
    return {k: float(v) for k, v in terms.items()}


@functools.lru_cache(maxsize=None)
def _run(case):
    """Two single steps and one K=2 call, in both packages, from the same
    weights: {"j_single": [terms, terms], "j_multi": terms, "t_single":
    [terms, terms], "t_multi": terms, snapshots, the first step's
    parameters}."""
    stage, train = CASES[case]
    jc, tc = _cfgs(train)
    h, w = HW
    batches = _batches(20 + stage)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    d_js = jstate.create_state(JDtoD(cfg=jc.model), (1, h, w, 1), jc.train, 4,
                               params=_init(JDtoD, 1, 1))
    if stage == 1:
        js0 = d_js
        jstep, jmulti = jsteps.make_stage1_step(jc), jsteps.make_stage1_multistep(jc, K)
        extra_j = ()
    else:
        js0 = jstate.create_state(JRtoD(cfg=jc.model), (1, h, w, 3), jc.train, 4,
                                  freeze_decoder=True,
                                  params=j_transfer(_init(JRtoD, 3, 2), d_js.params))
        jstep, jmulti = jsteps.make_stage2_step(jc), jsteps.make_stage2_multistep(jc, K)
        extra_j = (d_js.params,)
    out = {"j_single": []}
    js = jax.tree.map(jnp.copy, js0)
    for b in batches:
        js, t = jstep(js, *extra_j, b)
        out["j_single"].append(_floats(t))
    _, t = jmulti(jax.tree.map(jnp.copy, js0), *extra_j, stacked)
    out["j_multi"] = _floats(t)

    def port_state():
        if stage == 1:
            net = DtoDNet(tc.model)
            net.load_state_dict(_flat(js0.params), strict=True)
            return tstate.TrainState(net, tc.train, 4), ()
        d_net = DtoDNet(tc.model)
        d_net.load_state_dict(_flat(d_js.params), strict=True)
        net = RtoDNet(tc.model)
        net.load_state_dict(_flat(js0.params), strict=True)
        return (tstate.TrainState(net, tc.train, 4, freeze_decoder=True),
                (d_net.requires_grad_(False),))

    single = tsteps.make_stage1_step(tc) if stage == 1 else tsteps.make_stage2_step(tc)
    multi = (tsteps.make_stage1_multistep(tc, K) if stage == 1
             else tsteps.make_stage2_multistep(tc, K))
    st, extra = port_state()
    out["ema0"] = {k: v.clone() for k, v in (st.ema or {}).items()}
    out["t_single"], out["params_after"] = [], []
    for b in batches:
        st, t = single(st, *extra, _tb(b))
        out["t_single"].append(_floats(t))
        out["params_after"].append({k: v.clone() for k, v in st.net.state_dict().items()})
    out["single"] = _snapshot(st)
    st, extra = port_state()
    st, t = multi(st, *extra, {k: torch.from_numpy(v.copy()) for k, v in stacked.items()})
    out["t_multi"] = _floats(t)
    out["multi"] = _snapshot(st)
    out["decay"], out["accum"] = train.get("ema_decay"), train.get("grad_accum", 1)
    return out


def _close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert np.isfinite(got[k]), (what, k)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_multistep_equals_two_single_steps_bit_for_bit(case):
    r = _run(case)
    _bit_equal(r["multi"], r["single"])
    assert r["t_multi"] == r["t_single"][-1]
    step, updates = r["multi"]["counts"]
    assert step == K and updates == K // r["accum"]


@pytest.mark.parametrize("case", list(CASES))
def test_multistep_terms_match_jax_single_steps(case):
    r = _run(case)
    for i in range(K):
        _close(r["t_single"][i], r["j_single"][i], f"{case} step {i}")
    _close(r["t_multi"], r["j_single"][-1], f"{case} multistep")


@pytest.mark.parametrize("case", list(CASES))
def test_multistep_terms_match_jax_multistep(case):
    r = _run(case)
    _close(r["t_multi"], r["j_multi"], case)
    _close(r["j_multi"], r["j_single"][-1], f"{case}: JAX multistep vs its single steps")


def test_multistep_carries_the_ema_through_both_updates():
    """tests/test_ema_warmup.py's case on the port: after a K=2 call the
    EMA is d * (d * e0 + (1 - d) * p1) + (1 - d) * p2."""
    r = _run("stage1_ema")
    d = r["decay"]
    p1, p2 = r["params_after"]
    for k, e0 in r["ema0"].items():
        want = d * (d * e0 + (1 - d) * p1[k]) + (1 - d) * p2[k]
        torch.testing.assert_close(r["multi"]["ema"][k], want, rtol=1e-5, atol=1e-7)
    assert any(not torch.equal(r["multi"]["ema"][k], e0) for k, e0 in r["ema0"].items())


def test_multistep_with_grad_accum_applies_one_update():
    """grad_accum=2 with K=2: one call is one update on the mean
    gradient; the accumulator is clear after it."""
    r = _run("stage2_accum_clip_ema")
    assert r["multi"]["counts"] == (2, 1)
    assert all(bool(v.abs().sum() == 0) for v in r["multi"]["acc"].values())


def test_multistep_refuses_a_stack_of_another_size():
    _, tc = _cfgs({})
    net = DtoDNet(tc.model)
    net.load_state_dict(tckpt.init_params(tc.model, torch.Generator().manual_seed(0),
                                          in_channels=1))
    b = _batches(0)[0]
    batches = {k: torch.from_numpy(np.stack([v] * 3)) for k, v in b.items()}
    with pytest.raises(ValueError, match="stacked batch has 3 steps, expected "
                                         "steps_per_call=2"):
        tsteps.make_stage1_multistep(tc, K)(tstate.TrainState(net, tc.train, 4), batches)


# --------------------------------------------------------------------- loop

def test_loop_refuses_what_the_jax_loop_refuses():
    args = dict(step_fn=None, state=None, data_iter=None, steps=5, logger=None,
                batch_size=2, log_every=1, steps_per_call=2)
    with pytest.raises(ValueError) as want:
        jloop._epoch_loop(**args)
    with pytest.raises(ValueError) as got:
        tloop._epoch_loop(device=torch.device("cpu"), **args)
    assert str(got.value) == str(want.value) == (
        "steps_per_epoch=5 not divisible by steps_per_call=2")


class _Clock:
    """perf_counter that moves 0.25 s at each reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


class _Logger:
    def __init__(self):
        self.records = []

    def log(self, **kw):
        self.records.append(kw)


def _fake_loop(loop_mod, k, monkeypatch):
    """Run ``loop_mod._epoch_loop`` over 8 steps with a step that counts
    what it is given; -> (logged records, batch shapes seen)."""
    seen = []
    state = types.SimpleNamespace(step=0, optimizer=types.SimpleNamespace(
        param_groups=[{"lr": 0.5}]))

    def step_fn(state, batch):
        n = batch["depth"].shape[0] if k > 1 else 1
        seen.append(tuple(batch["depth"].shape))
        state.step += n
        return state, {"total": torch.tensor(float(state.step))}

    data = iter([{"depth": np.full((3, 2), i, np.float32)} for i in range(8)])
    monkeypatch.setattr(loop_mod, "time", _Clock())
    logger = _Logger()
    kw = dict(device=torch.device("cpu")) if loop_mod is tloop else {}
    loop_mod._epoch_loop(step_fn, state, data, 8, logger, 3, 4, steps_per_call=k, **kw)
    return logger.records, seen


@pytest.mark.parametrize("k", [1, 2, 4])
def test_loop_log_cadence_and_images_per_second_follow_the_jax_loop(k, monkeypatch):
    """Log every max(1, log_every // K) calls; images/s = B * K * calls
    timed / elapsed, the first call off the clock; K batches stacked."""
    got, seen = _fake_loop(tloop, k, monkeypatch)
    want, jseen = _fake_loop(jloop, k, monkeypatch)
    assert seen == jseen == [((k, 3, 2) if k > 1 else (3, 2))] * (8 // k)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert [r.get("imgs_per_sec") for r in got] == pytest.approx(
        [r.get("imgs_per_sec") for r in want], rel=1e-12)
    assert [r["total"] for r in got] == [r["total"] for r in want]
    assert all(r["lr"] == 0.5 for r in got)
    assert len(got) == (8 // k) // max(1, 4 // k)


@pytest.mark.parametrize("stage", [1, 2])
def test_trainers_run_the_multistep(stage, monkeypatch):
    """train_stage{1,2} with steps_per_call=2 take the multistep builder
    (one call a pair of batches) under GuardedStep, and count batches."""
    _, tc = _cfgs(dict(log_every=1, check_numerics=True))
    tc = dataclasses.replace(tc, data=dataclasses.replace(tc.data, batch_size=2))
    calls = []
    name = f"make_stage{stage}_multistep"
    real = getattr(tloop, name)

    def spy(cfg, k):
        fn = real(cfg, k)

        def step(state, *args):
            calls.append(args[-1]["depth"].shape[0])
            return fn(state, *args)

        return step

    monkeypatch.setattr(tloop, name, spy)
    data = SyntheticDataset(2, *HW, 80.0, seed=0, device="cpu")
    quiet = dict(logger=MetricLogger(stream=io.StringIO()), device="cpu")
    if stage == 1:
        state = tloop.train_stage1(tc, data, epochs=1, **quiet)
    else:
        d_sd = tckpt.init_params(tc.model, torch.Generator().manual_seed(0), in_channels=1)
        state = tloop.train_stage2(tc, data, d_sd, epochs=1, **quiet)
    assert calls == [K, K] and state.step == 4 and state.updates == 4


# ------------------------------------------------------------------ scripts

TINY = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32",
        "--height", "16", "--width", "32", "--batch_size", "1"]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_script_steps_per_call_resume_is_bit_for_bit(tmp_path):
    """Two epochs of 4 steps, 2 a call, against one epoch, a checkpoint
    and --resume for one more: the final checkpoints are equal bit for
    bit (parameters, EMA, Adam moments, counts, the data cursor)."""
    train = _load_script("train_torch")
    common = [*TINY, "--steps_per_epoch", "4", "--steps_per_call", "2", "--log_every",
              "2", "--ema_decay", "0.9", "--mode", "DtoD"]
    train.main([*common, "--epochs", "2", "--ckpt_dir", str(tmp_path / "a")])
    train.main([*common, "--epochs", "1", "--ckpt_dir", str(tmp_path / "b")])
    resumed = train.main([*common, "--epochs", "1", "--ckpt_dir", str(tmp_path / "b"),
                          "--resume"])
    assert resumed.step == 8
    a = tckpt._read(str(tmp_path / "a" / "stage1"), 8)
    b = tckpt._read(str(tmp_path / "b" / "stage1"), 8)
    assert a["step"] == b["step"] == 8 and a["loader"] == b["loader"] == {"step": 8}
    for key in ("params", "ema"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


def test_train_script_steps_per_call_with_fused_guidance(tmp_path, capsys):
    train = _load_script("train_torch")
    common = [*TINY, "--epochs", "1", "--steps_per_epoch", "4", "--steps_per_call", "2",
              "--log_every", "2", "--fused_guidance", "--ckpt_dir", str(tmp_path)]
    one = train.main(["--mode", "DtoD", *common])
    two = train.main(["--mode", "RtoD", *common])
    out = capsys.readouterr().out
    assert one.step == two.step == 4
    assert "[stage2] step=2" in out and "[stage2] step=4" in out
    cfg = tckpt.load_config(str(tmp_path / "stage2"))
    assert cfg.train.fused_guidance and cfg.train.steps_per_call == 2
