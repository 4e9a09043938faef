"""The port's command line (gdn_tpu_torch/cli.py) against the JAX
package's (gdn_tpu/cli.py), on the CPU.

- For a table of argv lists, ``gdn_tpu.cli.build_config`` and the port's
  ``build_config`` give equal values in every config field both
  packages have.  The one stated exception: the port sets
  ``model.use_pallas_gn`` (it launches the GroupNorm+ELU kernel at every
  unfused site on the card), which the JAX defaults leave off.
- Every flag for what the port does not run yet parses in both
  packages, and the port's Config refuses it with NotImplementedError
  naming its ROADMAP item; the scripts turn that into their parser's
  error.
- Every ModelConfig field of the port is categorized as architecture or
  execution (as tests/test_cli.py does for the JAX package's).
- The port's own flags: ``--ckpt_dir`` is ``--model_dir``, ``--device``,
  ``--dtype``, ``--model.<flag>``.
"""

import argparse
import dataclasses
import importlib.util
import os

import pytest

from gdn_tpu import cli as jcli
from gdn_tpu_torch import cli as tcli
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATED_EXCEPTIONS = {("model", "use_pallas_gn")}


def _parse(mod, argv, train=True, evalargs=False):
    p = argparse.ArgumentParser()
    mod.add_common_args(p)
    if train:
        mod.add_train_args(p)
    if evalargs:
        mod.add_eval_args(p)
    return p.parse_args(argv)


TRAIN_ARGV = [
    [],
    ["--dataset", "nyu"],
    ["--dataset", "synthetic", "--seed", "3", "--model_dir", "runs/x"],
    ["--mode", "RtoD", "--epochs", "7", "--lr", "3e-4", "--batch_size", "16",
     "--height", "96", "--width", "320", "--no_freeze_decoder"],
    ["--no_pallas"],
    ["--lr_schedule", "cosine", "--warmup_steps", "5"],
    ["--lr_schedule", "constant"],
    ["--decay_epochs", "3", "--decay_gamma", "0.3"],
    ["--grad_clip", "1.0", "--ema_decay", "0.99", "--grad_accum", "2"],
    ["--loader", "grain", "--workers", "2"],
    ["--eval_batch", "64", "--eval_every", "2", "--eval_max_images", "8"],
    ["--train_wire", "f32", "--decode_cache", "cache", "--train_list", "t.txt"],
    ["--device_cache", "--steps_per_epoch", "20", "--log_every", "5"],
    ["--ssim_precision", "highest", "--max_depth", "50"],
    ["--num_devices", "1", "--data_path", "/data/kitti"],
    ["--upsample", "resize_conv", "--norm", "group", "--deconv_init", "lecun"],
]
EVAL_ARGV = [
    [],
    ["--cap", "50", "--crop", "eigen", "--median_scaling", "--gt_wire", "u16",
     "--rgb_wire", "f32", "--eval_batch", "4"],
    ["--dataset", "nyu", "--crop", "none", "--val_list", "test.txt"],
    ["--calib_dir", "calib", "--max_images", "10", "--flip_tta", "--device_cache",
     "--use_ema", "--num_devices", "1"],
    ["--no_pallas", "--height", "64", "--width", "208"],
]


def _same_fields(tc, jc):
    """Every (section, field) that both Configs have, with its two values."""
    out = {}
    for section in dataclasses.fields(jc):
        js, ts = getattr(jc, section.name), getattr(tc, section.name, None)
        if ts is None:
            continue
        for f in dataclasses.fields(js):
            if hasattr(ts, f.name):
                out[(section.name, f.name)] = (getattr(ts, f.name), getattr(js, f.name))
    return out


@pytest.mark.parametrize("argv,evalargs", [(a, False) for a in TRAIN_ARGV]
                         + [(a, True) for a in EVAL_ARGV])
def test_build_config_equals_the_jax_one(argv, evalargs):
    kw = dict(train=not evalargs, evalargs=evalargs)
    tc = tcli.build_config(_parse(tcli, argv, **kw))
    jc = jcli.build_config(_parse(jcli, argv, **kw))
    fields = _same_fields(tc, jc)
    assert len(fields) > 80
    diff = {k: v for k, v in fields.items() if v[0] != v[1] and k not in STATED_EXCEPTIONS}
    assert diff == {}
    # the stated exception: the port's scripts launch the GN+ELU kernel
    assert tc.model.use_pallas_gn and not jc.model.use_pallas_gn


UNPORTED = [
    (["--upsample", "deconv"], "Queue A item 3"),
    (["--norm", "none"], "Queue A item 3"),
    (["--multiscale"], "Queue A item 3"),
    (["--steps_per_call", "2"], "Queue A item 12"),
    (["--fused_guidance"], "Queue A item 12"),
    (["--num_devices", "2"], "Queue A item 10"),
    (["--spatial_devices", "2"], "Queue A item 10"),
    (["--model_devices", "2"], "Queue A item 10"),
    (["--fsdp"], "Queue A item 10"),
    (["--device_cache_sharded"], "Queue A item 10"),
]


@pytest.mark.parametrize("argv,item", UNPORTED)
def test_unported_train_flags_are_refused_with_their_item(argv, item):
    jcli.build_config(_parse(jcli, argv))  # a flag the JAX package runs
    with pytest.raises(NotImplementedError, match=item):
        tcli.build_config(_parse(tcli, argv))


@pytest.mark.parametrize("argv,item", [
    (["--num_devices", "4"], "Queue A item 10"),
    (["--quantize", "int8"], "Queue A item 11"),
    (["--artifact", "model.bin"], "Queue A item 11"),
])
def test_unported_eval_and_serve_flags_are_refused_with_their_item(argv, item):
    p = argparse.ArgumentParser()
    tcli.add_common_args(p)
    tcli.add_eval_args(p)
    p.add_argument("--quantize", choices=["none", "int8"], default="none")
    p.add_argument("--artifact", default="")
    with pytest.raises(NotImplementedError, match=item):
        tcli.build_config(p.parse_args(argv))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,argv,item", [
    ("train_torch", ["--upsample", "deconv"], "Queue A item 3"),
    ("train_torch", ["--steps_per_call", "4"], "Queue A item 12"),
    ("train_torch", ["--fsdp"], "Queue A item 10"),
    ("serve_torch", ["--init_random", "--quantize", "int8"], "Queue A item 11"),
    ("serve_torch", ["--artifact", "m.bin"], "Queue A item 11"),
    ("demo_torch", ["--input", "x.png", "--norm", "none"], "Queue A item 3"),
    ("profile_step_torch", ["--upsample", "deconv"], "Queue A item 3"),
])
def test_scripts_turn_a_refusal_into_a_parser_error(script, argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        _load_script(script).parse_args(argv)
    assert e.value.code != 0
    assert item in capsys.readouterr().err


def test_every_model_config_field_is_categorized():
    """The port's ModelConfig splits like the JAX one: a new field fails
    here until it is marked an execution field or named architecture."""
    architecture = {
        "image_size", "enc_channels", "dec_channels", "norm", "group_norm_groups",
        "activation", "upsample", "deconv_gn", "deconv_init", "fusion",
        "multiscale_heads", "max_depth", "min_depth",
    }
    execution = {f.name for f in dataclasses.fields(tcfg.ModelConfig)
                 if f.metadata.get("execution")}
    every = {f.name for f in dataclasses.fields(tcfg.ModelConfig)}
    assert architecture & execution == set()
    assert architecture | execution == every, sorted(every - architecture - execution)
    from gdn_tpu.config import ModelConfig as JModelConfig

    assert execution == {f.name for f in dataclasses.fields(JModelConfig)
                         if f.metadata.get("execution")}


def test_port_flags_ckpt_dir_device_dtype_and_fused_routes():
    a = _parse(tcli, ["--ckpt_dir", "somewhere", "--device", "cpu", "--dtype", "float32",
                      "--model.use_pallas_fusion"])
    b = _parse(tcli, ["--model_dir", "somewhere", "--device", "cpu", "--dtype", "float32",
                      "--model.use_pallas_fusion"])
    assert vars(a) == vars(b)
    cfg = tcli.build_config(a)
    assert cfg.train.ckpt_dir == "somewhere" and cfg.model.dtype == "float32"
    assert cfg.model.use_pallas_fusion and not cfg.model.use_pallas_convgn_bt
    assert _parse(tcli, []).device == "cuda"
    with pytest.raises(SystemExit):
        _parse(tcli, ["--device", "tpu"])


def test_apply_saved_model_config_with_the_new_surface(tmp_path, capsys):
    """Adopt a checkpoint's architecture, keep the environment's execution
    fields, and let an explicit flag win, as the JAX function does."""
    trained = tcfg.kitti_config(**{"model.image_size": (64, 208),
                                   "model.max_depth": 50.0, "model.dtype": "float32"})
    save_config(str(tmp_path), trained)
    env = tcli.build_config(_parse(tcli, []))
    cfg = tcli.apply_saved_model_config(env, _parse(tcli, []), str(tmp_path))
    assert cfg.model.image_size == (64, 208) and cfg.model.max_depth == 50.0
    assert cfg.model.dtype == env.model.dtype and cfg.model.use_pallas_gn
    wins = tcli.apply_saved_model_config(env, _parse(tcli, ["--height", "32"]), str(tmp_path))
    assert wins.model.image_size == (32, 208)
    assert "WARNING" in capsys.readouterr().out
