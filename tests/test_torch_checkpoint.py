"""Checkpoints of the PyTorch port against the JAX package.

- ``config.json`` both ways: a Config written by either package's
  ``save_config`` rebuilds the same Config in the other; an unported
  value raises the port's NotImplementedError naming its ROADMAP item.
- ``cli.apply_saved_model_config`` against the JAX package's on the
  cases of tests/test_cli.py (adopt the architecture, keep the
  execution fields of the environment, flags win, no config.json).
- A JAX checkpoint with an EMA, exported by scripts/export_torch.py
  (with and without ``--use_ema``), loads strict into the port with the
  checkpoint's config adopted, and its fp32 forward matches flax's.
- The port's checkpoint files: ``keep_ckpts``, an asynchronous save and
  its wait, a torn temporary file, ``load_params`` of a missing EMA, and
  a restore made in inference mode.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from gdn_tpu import checkpoint as jckpt
from gdn_tpu import cli as jcli
from gdn_tpu import config as jcfg
from gdn_tpu.models import RtoDNet as JRtoD
from gdn_tpu.train import create_state
from gdn_tpu_torch import checkpoint as tckpt
from gdn_tpu_torch import cli as tcli
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"model.image_size": (16, 32), "model.enc_channels": (8, 16),
         "model.dec_channels": (16, 8)}
TRAINED = [  # configs a run may have saved: architecture, loss, data and train knobs
    dict(SMALL, **{"train.ema_decay": 0.999, "train.grad_accum": 2, "train.remat": True,
                   "train.grad_clip": 1.0, "model.max_depth": 50.0,
                   "data.scale_range": (1.0, 1.3), "loss.w_ssim": 0.25}),
    {"model.dtype": "float32", "model.use_pallas_convgn_bt": True,
     "model.resize_conv_composed": False, "eval.crop": "eigen", "train.keep_ckpts": 1,
     "train.async_ckpt": False},
]


def _args(**kw):
    """A parsed command line with the architecture flags either CLI reads."""
    base = dict(height=None, width=None, max_depth=None, upsample=None, deconv_init=None,
                norm=None, multiscale=False)
    return argparse.Namespace(**{**base, **kw})


# ------------------------------------------------------------- config.json

@pytest.mark.parametrize("preset", ["kitti", "nyu"])
@pytest.mark.parametrize("case", range(len(TRAINED)))
def test_config_json_both_ways(tmp_path, preset, case):
    jc = getattr(jcfg, f"{preset}_config")(**TRAINED[case])
    jckpt.save_config(str(tmp_path / "j"), jc)
    tc = tckpt.load_config(str(tmp_path / "j"))
    assert isinstance(tc, tcfg.Config)
    assert tc == getattr(tcfg, f"{preset}_config")(**TRAINED[case])
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert isinstance(tc.model.image_size, tuple) and isinstance(tc.data.scale_range, tuple)
    tckpt.save_config(str(tmp_path / "t"), tc)
    assert jckpt.load_config(str(tmp_path / "t")) == jc
    with open(tmp_path / "j" / "config.json") as a, open(tmp_path / "t" / "config.json") as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("over,item", [
    ({"model.upsample": "deconv"}, "Queue A item 3"),
    ({"model.norm": "none"}, "Queue A item 3"),
    ({"train.remat_policy": "dots_saveable"}, "Queue A item 5"),
    ({"train.steps_per_call": 4}, "Queue A item 12"),
])
def test_config_json_refuses_what_the_port_does_not_run(tmp_path, over, item):
    jckpt.save_config(str(tmp_path), jcfg.kitti_config(**over))
    with pytest.raises(NotImplementedError, match=item):
        tckpt.load_config(str(tmp_path))


def test_config_json_drops_unknown_keys(tmp_path, capsys):
    tckpt.save_config(str(tmp_path), tcfg.kitti_config())
    path = tmp_path / "config.json"
    payload = json.loads(path.read_text())
    payload["model"]["knob_from_the_future"] = 7
    path.write_text(json.dumps(payload))
    assert tckpt.load_config(str(tmp_path)) == tcfg.kitti_config()
    assert "knob_from_the_future" in capsys.readouterr().out
    assert tckpt.load_config(str(tmp_path / "nothing")) is None


def test_execution_fields_are_the_jax_packages():
    def execution(cls):
        return {f.name for f in dataclasses.fields(cls) if f.metadata.get("execution")}

    assert execution(tcfg.ModelConfig) == execution(jcfg.ModelConfig)
    assert [f.name for f in dataclasses.fields(tcfg.ModelConfig)] == [
        f.name for f in dataclasses.fields(jcfg.ModelConfig)]


# ------------------------------------------------- apply_saved_model_config

ADOPT_CASES = {
    "no_flags": dict(env={}, args={}),
    "height_width_win": dict(env={}, args=dict(height=24, width=40)),
    "max_depth_wins": dict(env={}, args=dict(max_depth=10.0)),
    "execution_from_env": dict(env={"model.use_pallas_fusion": True,
                                    "model.dtype": "float32",
                                    "model.resize_conv_composed": False}, args={}),
}


@pytest.mark.parametrize("name", list(ADOPT_CASES))
def test_apply_saved_model_config_matches_jax(tmp_path, name, capsys):
    case = ADOPT_CASES[name]
    trained = {**SMALL, "model.max_depth": 50.0, "model.use_pallas": False,
               "model.dtype": "bfloat16", "train.ema_decay": 0.999}
    d = str(tmp_path / "stage2")
    jckpt.save_config(d, jcfg.kitti_config(**trained))
    want = jcli.apply_saved_model_config(jcfg.kitti_config(**case["env"]),
                                         _args(**case["args"]), d)
    got = tcli.apply_saved_model_config(tcfg.kitti_config(**case["env"]),
                                        _args(**case["args"]), d)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert got.train == tcfg.kitti_config(**case["env"]).train  # only the model is adopted
    out = capsys.readouterr().out
    assert "adopted model config" in out
    if case["args"]:
        assert "WARNING" in out


def test_apply_saved_model_config_without_config_json(tmp_path):
    base = tcfg.kitti_config()
    assert tcli.apply_saved_model_config(base, _args(), str(tmp_path / "none")) is base


def test_apply_saved_model_config_flag_for_an_unported_branch(tmp_path):
    """--upsample deconv on a resize_conv checkpoint: the JAX CLI honors
    the flag; the port refuses the branch, naming its ROADMAP item."""
    d = str(tmp_path)
    jckpt.save_config(d, jcfg.kitti_config(**SMALL))
    want = jcli.apply_saved_model_config(jcfg.kitti_config(), _args(upsample="deconv"), d)
    assert want.model.upsample == "deconv" and want.model.enc_channels == (8, 16)
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        tcli.apply_saved_model_config(tcfg.kitti_config(), _args(upsample="deconv"), d)


# ------------------------------------- a JAX checkpoint through export_torch

def _export(monkeypatch, capsys, model_dir, pth, *extra):
    spec = importlib.util.spec_from_file_location(
        "export_torch", os.path.join(REPO, "scripts", "export_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["export_torch.py", "--stage", "2", "--model_dir",
                                      model_dir, "--pth", pth, *extra])
    mod.main()
    assert "wrote" in capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny stage-2 JAX checkpoint whose EMA differs from its params,
    at a non-default size and max depth."""
    root = str(tmp_path_factory.mktemp("jax_ck"))
    cfg = jcfg.kitti_config(**{**SMALL, "model.max_depth": 50.0, "model.dtype": "float32",
                               "train.ema_decay": 0.99, "train.ckpt_dir": root})
    state = create_state(JRtoD(cfg=cfg.model), (1, 16, 32, 3), cfg.train, 1)
    ema = jax.tree_util.tree_map(
        lambda p: p * 0.9 + 0.01 * np.sign(np.asarray(p) + 0.5), state.params)
    state = state.replace(ema_params=ema)
    jckpt.save_checkpoint(os.path.join(root, "stage2"), 3, state, cfg=cfg)
    return root, cfg, state


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_jax_checkpoint_exported_loads_strict_and_matches_flax(
        jax_checkpoint, tmp_path, monkeypatch, capsys, use_ema):
    root, jc, state = jax_checkpoint
    pth = str(tmp_path / "w.pth")
    _export(monkeypatch, capsys, root, pth, *(["--use_ema"] if use_ema else []))
    # the port adopts the architecture from the JAX run's config.json
    cfg = tcli.apply_saved_model_config(
        tcfg.kitti_config(**{"model.dtype": "float32", "model.use_pallas_gn": True}),
        _args(), os.path.join(root, "stage2"))
    capsys.readouterr()
    assert cfg.model.image_size == (16, 32) and cfg.model.max_depth == 50.0
    net = RtoDNet(cfg.model)
    net.load_state_dict(tckpt.load_pth(pth), strict=True)
    params = state.ema_params if use_ema else state.params
    x = np.random.default_rng(4).uniform(0, 1, (2, 16, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: JRtoD(cfg=jc.model).apply({"params": p}, x))(
        params, x)["depth"])
    with torch.no_grad():
        got = net(torch.from_numpy(x))["depth"].numpy()
    # fp32 through ~40 layers on both sides: within 1e-5 of the depth range
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * jc.model.max_depth)
    # the file holds the set asked for (the EMA differs from the params)
    kernel = np.asarray(params["encoder"]["stem"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(tckpt.load_pth(pth)["encoder.stem.Conv_0.kernel"].numpy(),
                                  np.transpose(kernel, (3, 2, 0, 1)))


# ------------------------------------------------ the port's checkpoint files

def _state(ema=True, accum=1):
    cfg = tcfg.kitti_config(**{**SMALL, "model.dtype": "float32",
                               "train.ema_decay": 0.9 if ema else None,
                               "train.grad_accum": accum})
    gen = torch.Generator().manual_seed(0)
    net = DtoDNet(cfg.model)
    net.load_state_dict(tckpt.init_params(cfg.model, gen, in_channels=1))
    return cfg, TrainState(net, cfg.train, 10)


def _step(state, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in state.params:
        p.grad = torch.randn(p.shape, generator=gen)
    state.apply_gradients()


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_keep_ckpts_keeps_the_newest_and_ignores_temporary_files(tmp_path):
    cfg, state = _state()
    d = str(tmp_path / "stage1")
    for s in range(1, 5):
        _step(state, s)
        tckpt.save_checkpoint(d, state.step, state, keep=2, cfg=cfg,
                              loader_state={"step": state.step})
    assert sorted(os.listdir(d)) == ["3.pt", "4.pt", "config.json"]
    (tmp_path / "stage1" / "9.pt.123.tmp").write_bytes(b"torn")
    (tmp_path / "stage1" / "x.pt").write_bytes(b"not a step")
    assert tckpt.latest_step(d) == 4
    assert tckpt.load_loader_state(d) == {"step": 4}
    assert tckpt.load_loader_state(d, step=3) == {"step": 3}
    assert tckpt.load_config(d) == cfg
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_params(str(tmp_path / "none"))


def test_async_save_copies_before_returning_and_the_wait_covers_every_stage(tmp_path):
    _, state = _state(accum=2)
    _step(state, 1)  # mid-accumulation: the buffers hold a gradient
    saved = tckpt._to_host(state.state_dict())
    for stage in ("stage1", "stage2", "stage2_best"):
        tckpt.save_checkpoint(str(tmp_path / stage), state.step, state, use_async=True)
    _step(state, 2)  # updates the parameters in place while the writes run
    tckpt.wait_for_checkpoints(str(tmp_path))
    for stage in ("stage1", "stage2", "stage2_best"):
        payload = torch.load(tmp_path / stage / "1.pt", weights_only=True)
        assert set(payload) == {"params", "ema", "optimizer", "step", "updates", "accum"}
        assert _same(payload, saved), stage
    assert not _same(saved["params"], state.state_dict()["params"])
    assert payload["step"] == 1 and payload["updates"] == 0


def test_load_params_of_a_run_without_ema_says_so(tmp_path):
    _, state = _state(ema=False)
    _step(state, 1)
    tckpt.save_checkpoint(str(tmp_path), 1, state)
    sd = tckpt.load_params(str(tmp_path))
    assert all(torch.equal(sd[k], v) for k, v in state.net.state_dict().items())
    with pytest.raises(KeyError, match="no 'ema'"):
        tckpt.load_params(str(tmp_path), key="ema")


def test_restore_in_inference_mode_gives_trainable_tensors(tmp_path):
    cfg, state = _state()
    _step(state, 1)
    tckpt.save_checkpoint(str(tmp_path), 1, state)
    _, fresh = _state()
    with torch.inference_mode():
        tckpt.restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == fresh.updates == 1
    for t in [*fresh.net.parameters(), *fresh.ema.values()]:
        assert not t.is_inference()
    for st in fresh.optimizer.state.values():
        assert not any(v.is_inference() for v in st.values())
    _step(fresh, 2)
    _step(state, 2)
    assert _same(tckpt._to_host(fresh.state_dict()), tckpt._to_host(state.state_dict()))


def test_restore_refuses_a_checkpoint_of_another_run_shape(tmp_path):
    _, state = _state(ema=False)
    _step(state, 1)
    tckpt.save_checkpoint(str(tmp_path), 1, state)
    with pytest.raises(ValueError, match="'ema'"):
        tckpt.restore_checkpoint(str(tmp_path), _state(ema=True)[1])
    with pytest.raises(ValueError, match="'accum'"):
        tckpt.restore_checkpoint(str(tmp_path), _state(ema=False, accum=2)[1])
