"""The ``.pth`` migration path of the PyTorch port against the JAX
package's, on the CPU: one reference-style ``.pth`` and one key map go
through both packages.

- ``gdn_tpu_torch.checkpoint.params_from_torch`` equals
  ``gdn_tpu.checkpoint.params_from_torch`` followed by
  ``params_from_flax`` bit for bit, with and without a key map: a
  square conv, extra keys ignored, the same leaves named by ``strict``
  and by a shape mismatch, and a partial import whose matched leaves
  are JAX's and whose others are the port's own fresh weights.
- ``params_to_torch``: the same keys and tensors as the JAX function on
  the same weights; each package's output imports bit for bit through
  the other's.
- ``scripts/import_pth_torch.py`` against ``scripts/import_torch.py``
  (both in this process) on a ``.pth`` wrapped as ``{"state_dict": ...}``
  with ``module.`` keys, stages 1 and 2: the checkpoints hold the same
  weights; ``--partial``; a missing key stops it naming the leaf; the
  import restores into a fresh state, trains from ``--stage1_ckpt``,
  resumes from step 0, is scored by ``eval_torch.py`` and drawn by
  ``demo_torch.py``; the imported G-net's fp32 forward against flax's.
- ``scripts/export_pth_torch.py`` against ``scripts/export_torch.py``
  on the same weights (an EMA that differs from the params) saved by
  each package: the same ``.pth`` of the params under their own keys
  and of the EMA under a key map (``--use_ema --key_map``); without an
  EMA it stops naming ``ema``.

The nets are small (two encoder levels, 16x32); each script reads its
build_config through the small-net override below.
"""

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
from gdn_tpu.models import DtoDNet as JDtoD
from gdn_tpu.models import RtoDNet as JRtoD
from gdn_tpu.train import create_state
from gdn_tpu_torch import checkpoint as tckpt
from gdn_tpu_torch import cli as tcli
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 16, 32
SMALL = {"model.image_size": (H, W), "model.enc_channels": (8, 16),
         "model.dec_channels": (16, 8)}
SOURCE_SEED = 20  # the reference-style weights
PARTIAL_DROP = 3  # leaves a partial .pth lacks
STRICT_DROP = 7  # more than the five a KeyError names
NETS = {"1": (JDtoD, DtoDNet, 1), "2": (JRtoD, RtoDNet, 3)}


def _flat(tree, prefix=""):
    """{flax path "a/b/c": leaf} of a JAX parameter tree, in its order."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def templates():
    """Per stage: a JAX parameter tree of the small net (zeros in the
    shapes flax's init gives: a template's values are never imported)
    and the port's fresh state_dict (init_params, seed 0)."""
    jc = jcfg.kitti_config(**SMALL)
    tc = tcfg.kitti_config(**SMALL)
    out = {}
    for stage, (jnet, tnet, ch) in NETS.items():
        shapes = jax.eval_shape(jnet(cfg=jc.model).init, jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct((1, H, W, ch), np.float32))["params"]
        jparams = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        tsd = tckpt.init_params(tc.model, torch.Generator().manual_seed(0), in_channels=ch)
        assert list(tsd) == list(tnet(tc.model).state_dict())
        # the port's keys are the flax paths with dots (JAX's own lookup rule)
        assert sorted(tsd) == sorted(p.replace("/", ".") for p in _flat(jparams))
        out[stage] = (jparams, tsd)
    return out


def _key_map(jparams, every=2):
    """Every ``every``-th flax path renamed as a reference's module might
    be; the others keep the default lookup."""
    return {p: f"net.layer{i}.{p.rsplit('/', 1)[1]}"
            for i, p in enumerate(_flat(jparams)) if i % every == 0}


def _source(jparams, key_map, seed=SOURCE_SEED):
    """A reference-style state_dict: float32 tensors in OIHW under the
    key map's names (a 4-D leaf's OIHW shape from its HWIO one)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for path, leaf in _flat(jparams).items():
        shape = np.shape(leaf)
        if len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        key = (key_map or {}).get(path, path.replace("/", "."))
        sd[key] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return sd


def _jax_import(jparams, sd, key_map=None, strict=True):
    """gdn_tpu's import followed by the port's carry of a flax tree."""
    tree = jckpt.params_from_torch(jparams, sd, key_map=key_map, strict=strict)
    return tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


# ----------------------------------------------------- params_from_torch

@pytest.mark.parametrize("mapped", [False, True], ids=["own_keys", "key_map"])
@pytest.mark.parametrize("stage", ["1", "2"])
def test_params_from_torch_equals_jax(templates, stage, mapped):
    jparams, tsd = templates[stage]
    key_map = _key_map(jparams) if mapped else None
    sd = _source(jparams, key_map)
    want = _jax_import(jparams, sd, key_map)
    got = tckpt.params_from_torch(tsd, sd, key_map=key_map)
    assert list(got) == list(tsd)  # the template's order, a state_dict's
    _assert_same(got, want)
    # the template is not touched
    _assert_same(tsd, tckpt.init_params(tcfg.kitti_config(**SMALL).model,
                                        torch.Generator().manual_seed(0),
                                        in_channels=NETS[stage][2]))


def test_params_from_torch_square_conv_is_oihw():
    """O = I = kh = kw: nothing tells the layouts apart by shape; the JAX
    import permutes OIHW -> HWIO unconditionally and the port keeps
    OIHW, so the two agree after params_from_flax."""
    oihw = np.arange(3 ** 4, dtype=np.float32).reshape(3, 3, 3, 3)
    jt = {"conv": {"kernel": np.zeros((3, 3, 3, 3), np.float32)}}
    want = _jax_import(jt, {"conv.kernel": oihw})
    got = tckpt.params_from_torch({"conv.kernel": torch.zeros(3, 3, 3, 3)},
                                  {"conv.kernel": torch.from_numpy(oihw)})
    _assert_same(got, want)
    np.testing.assert_array_equal(got["conv.kernel"].numpy(), oihw)


def test_params_from_torch_ignores_extra_keys_and_copies_float32(templates):
    jparams, tsd = templates["2"]
    sd = _source(jparams, None)
    extra = {**{k: v.double() for k, v in sd.items()},
             "optimizer.step": torch.tensor(3), "head.extra.weight": torch.ones(2, 2)}
    got = tckpt.params_from_torch(tsd, extra)
    _assert_same(got, _jax_import(jparams, extra))
    _assert_same(got, {k: sd[k] for k in tsd})
    # copies: the source's tensors are not aliased
    got["encoder.stem.Conv_0.kernel"].add_(1.0)
    assert not torch.equal(got["encoder.stem.Conv_0.kernel"], sd["encoder.stem.Conv_0.kernel"])


@pytest.mark.parametrize("mapped", [False, True], ids=["own_keys", "key_map"])
def test_strict_names_the_same_first_five_leaves(templates, mapped):
    jparams, tsd = templates["2"]
    key_map = _key_map(jparams) if mapped else None
    sd = _source(jparams, key_map)
    for k in list(sd)[1::4][:STRICT_DROP]:
        del sd[k]
    with pytest.raises(KeyError) as jerr:
        _jax_import(jparams, sd, key_map)
    with pytest.raises(KeyError) as terr:
        tckpt.params_from_torch(tsd, sd, key_map=key_map)
    assert terr.value.args[0] == jerr.value.args[0]
    assert f"missing {STRICT_DROP} template leaves" in terr.value.args[0]


def test_shape_mismatch_names_both_keys(templates):
    jparams, tsd = templates["1"]
    key_map = _key_map(jparams)
    sd = _source(jparams, key_map)
    bad = key_map.get("decoder/up0/fuse/kernel", "decoder.up0.fuse.kernel")
    sd[bad] = torch.zeros(sd[bad].shape[0] + 1, *sd[bad].shape[1:])
    with pytest.raises(ValueError) as jerr:
        _jax_import(jparams, sd, key_map)
    with pytest.raises(ValueError) as terr:
        tckpt.params_from_torch(tsd, sd, key_map=key_map)
    for msg in (jerr.value.args[0], terr.value.args[0]):
        assert f"{bad!r} -> 'decoder/up0/fuse/kernel'" in msg
    assert f"{tuple(sd[bad].shape)} vs {tuple(tsd['decoder.up0.fuse.kernel'].shape)}" in (
        terr.value.args[0])


def test_partial_import_keeps_the_ports_fresh_weights(templates):
    jparams, tsd = templates["2"]
    key_map = _key_map(jparams, every=3)
    sd = _source(jparams, key_map)
    dropped = list(sd)[2::5][:PARTIAL_DROP]
    for k in dropped:
        del sd[k]
    want = _jax_import(jparams, sd, key_map, strict=False)
    got = tckpt.params_from_torch(tsd, sd, key_map=key_map, strict=False)
    inverse = {v: k for k, v in key_map.items()}
    missing = {inverse.get(k, k.replace(".", "/")).replace("/", ".") for k in dropped}
    assert len(missing) == PARTIAL_DROP and missing <= set(tsd)
    for k in tsd:
        # matched leaves are JAX's import; the others the port's init_params
        assert torch.equal(got[k], tsd[k] if k in missing else want[k]), k


# -------------------------------------------------------- params_to_torch

@pytest.mark.parametrize("mapped", [False, True], ids=["own_keys", "key_map"])
def test_params_to_torch_equals_jax_and_round_trips(templates, mapped):
    jparams, tsd = templates["2"]
    key_map = _key_map(jparams) if mapped else None
    # one set of weights in both packages' layouts
    flax = jckpt.params_from_torch(jparams, _source(jparams, None, seed=SOURCE_SEED + 1))
    flax = jax.tree_util.tree_map(np.asarray, flax)
    port = tckpt.params_from_flax(flax)
    want = jckpt.params_to_torch(flax, key_map=key_map)
    got = tckpt.params_to_torch(port, key_map=key_map)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # each package's export through the other's import, bit for bit
    _assert_same(tckpt.params_from_torch(tsd, want, key_map=key_map), port)
    back = jckpt.params_from_torch(jparams, got, key_map=key_map)
    for path, leaf in _flat(flax).items():
        np.testing.assert_array_equal(np.asarray(_flat(back)[path]), leaf, err_msg=path)
    _assert_same(tckpt.params_from_torch(tsd, got, key_map=key_map), port)


# ------------------------------------------------------------- the scripts

def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_nets(monkeypatch):
    """Both packages' build_config give the small net the tests use (the
    channel widths have no flag)."""
    for cli, cfgmod in ((jcli, jcfg), (tcli, tcfg)):
        def build(args, _orig=cli.build_config, _with=cfgmod._with):
            return _with(_orig(args), **SMALL)

        monkeypatch.setattr(cli, "build_config", build)


def _run_jax(monkeypatch, name, *argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _script(name).main()


CPU = ("--device", "cpu", "--dtype", "float32")


def _wrapped_pth(path, sd):
    """A reference's file: {"state_dict": ...} with DataParallel's keys."""
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 7}, path)


@pytest.mark.parametrize("stage", ["1", "2"])
def test_import_script_equals_jax_import_script(templates, small_nets, tmp_path, monkeypatch,
                                                capsys, stage):
    jparams, tsd = templates[stage]
    key_map = _key_map(jparams)
    sd = _source(jparams, key_map)
    pth, km = str(tmp_path / "ref.pth"), str(tmp_path / "map.json")
    _wrapped_pth(pth, sd)
    with open(km, "w") as f:
        json.dump(key_map, f)
    args = ("--pth", pth, "--stage", stage, "--key_map", km)
    _run_jax(monkeypatch, "import_torch", *args, "--model_dir", str(tmp_path / "jax"))
    out_dir = _script("import_pth_torch").main(
        [*args, "--model_dir", str(tmp_path / "port"), *CPU])
    assert f"imported {len(sd)} torch tensors -> {out_dir} (step 0)" in capsys.readouterr().out
    assert sorted(os.listdir(out_dir)) == ["0.pt"]  # no config.json: readers take flags
    jnet, tnet, ch = NETS[stage]
    flax = jckpt.load_params(str(tmp_path / "jax" / f"stage{stage}"), jparams)
    got = tckpt.load_params(out_dir)
    _assert_same(got, {k: tckpt.params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax))[k] for k in tsd})
    # restores into a fresh state of the stage, at step 0
    from gdn_tpu_torch.train.loop import stage1_state, stage2_state

    cfg = tcfg.kitti_config(**SMALL, **{"model.dtype": "float32"})
    fresh = stage1_state(cfg, "cpu") if stage == "1" else stage2_state(cfg, None, "cpu")
    state = tckpt.restore_checkpoint(out_dir, fresh)
    assert (state.step, state.updates) == (0, 0)
    _assert_same(state.net.state_dict(), got)
    if stage == "1":
        return
    # the fp32 forward of the imported G-net against flax on the same input
    x = np.random.default_rng(4).uniform(0, 1, (2, H, W, ch)).astype(np.float32)
    jc = jcfg.kitti_config(**SMALL, **{"model.dtype": "float32"})
    want = np.asarray(jax.jit(lambda p, x: jnet(cfg=jc.model).apply({"params": p}, x))(
        flax, x)["depth"])
    with torch.no_grad():
        depth = state.net.eval()(torch.from_numpy(x))["depth"].numpy()
    np.testing.assert_allclose(depth, want, rtol=0, atol=1e-5 * cfg.model.max_depth)


def test_import_script_partial_and_missing(templates, small_nets, tmp_path, monkeypatch,
                                           capsys):
    jparams, tsd = templates["1"]
    sd = _source(jparams, None)
    dropped = list(sd)[1::6][:PARTIAL_DROP]
    for k in dropped:
        del sd[k]
    pth = str(tmp_path / "ref.pth")
    _wrapped_pth(pth, sd)
    port = str(tmp_path / "port")
    with pytest.raises(KeyError) as jerr:  # what scripts/import_torch.py raises
        jckpt.params_from_torch(jparams, sd)
    with pytest.raises(SystemExit) as terr:
        _script("import_pth_torch").main(["--pth", pth, "--model_dir", port, *CPU])
    assert jerr.value.args[0] in str(terr.value)
    for k in dropped:
        assert repr(k.replace(".", "/")) in str(terr.value)
    assert not os.path.exists(os.path.join(port, "stage1"))
    _run_jax(monkeypatch, "import_torch", "--pth", pth, "--model_dir",
             str(tmp_path / "jax"), "--partial")
    _script("import_pth_torch").main(["--pth", pth, "--model_dir", port, "--partial", *CPU])
    capsys.readouterr()
    flax = jckpt.load_params(str(tmp_path / "jax" / "stage1"), jparams)
    want = tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, flax))
    got = tckpt.load_params(os.path.join(port, "stage1"))
    for k in tsd:
        # the port's fresh D-net is init_params at the run's seed, 0
        assert torch.equal(got[k], tsd[k] if k in dropped else want[k]), k


def test_imported_checkpoints_train_resume_score_and_draw(templates, small_nets, tmp_path,
                                                          capsys):
    """A stage-1 import feeds train_torch.py --stage1_ckpt; a stage-2
    import resumes from step 0 and is read by eval_torch.py and
    demo_torch.py, all with the flags describing the net (no
    config.json)."""
    from PIL import Image

    root = str(tmp_path / "imported")
    for stage in ("1", "2"):
        pth = str(tmp_path / f"s{stage}.pth")
        _wrapped_pth(pth, _source(templates[stage][0], None, seed=SOURCE_SEED + int(stage)))
        _script("import_pth_torch").main(["--pth", pth, "--stage", stage,
                                          "--model_dir", root, *CPU])
    train = ("--dataset", "synthetic", "--height", str(H), "--width", str(W),
             "--batch_size", "2", "--epochs", "1", "--steps_per_epoch", "1",
             "--log_every", "1", *CPU)
    trainer = _script("train_torch")
    stage1 = os.path.join(root, "stage1")
    state = trainer.main(["--mode", "RtoD", "--stage1_ckpt", stage1,
                          "--model_dir", str(tmp_path / "fresh"), *train])
    assert state.step == 1
    d_sd = tckpt.load_params(stage1)
    for k, v in state.net.decoder.state_dict().items():  # the imported decoder, frozen
        assert torch.equal(v, d_sd[f"decoder.{k}"]), k
    state = trainer.main(["--mode", "RtoD", "--resume", "--model_dir", root, *train])
    assert state.step == 1
    assert "resumed stage 2 at step 0" in capsys.readouterr().out
    imported = tckpt.load_params(os.path.join(root, "stage2"), step=0)
    assert not torch.equal(state.net.state_dict()["encoder.stem.Conv_0.kernel"],
                           imported["encoder.stem.Conv_0.kernel"])
    os.remove(os.path.join(root, "stage2", "1.pt"))  # score and draw the import itself
    metrics = _script("eval_torch").main(
        ["--model_dir", root, "--dataset", "synthetic", "--max_images", "2",
         "--eval_batch", "2", "--height", str(H), "--width", str(W), *CPU])
    assert np.isfinite(metrics["rmse"])
    frames = tmp_path / "frames"
    frames.mkdir()
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (20, 40, 3), np.uint8)).save(
        frames / "f.png")
    written = _script("demo_torch").main(
        ["--input", str(frames), "--output", str(tmp_path / "demo"), "--model_dir", root,
         "--height", str(H), "--width", str(W), *CPU])
    assert [os.path.basename(p) for p in written] == ["f_depth.png"]


@pytest.fixture(scope="module")
def saved_both(tmp_path_factory):
    """One set of stage-2 weights with an EMA that differs from them,
    saved as a JAX checkpoint and as a port checkpoint (each with its
    config.json), and a port checkpoint without an EMA."""
    root = tmp_path_factory.mktemp("both")
    over = {**SMALL, "model.max_depth": 50.0, "train.ema_decay": 0.99}
    jc = jcfg.kitti_config(**over)
    state = create_state(JRtoD(cfg=jc.model), (1, H, W, 3), jc.train, 1)
    ema = jax.tree_util.tree_map(
        lambda p: p * 0.9 + 0.01 * np.sign(np.asarray(p) + 0.5), state.params)
    state = state.replace(ema_params=ema)
    jckpt.save_checkpoint(str(root / "jax" / "stage2"), 3, state, cfg=jc)
    tc = tcfg.kitti_config(**over, **{"model.dtype": "float32"})
    net = RtoDNet(tc.model)
    net.load_state_dict(tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                      state.params)))
    port = TrainState(net, tc.train, 1)
    port.ema = tckpt.params_from_flax(jax.tree_util.tree_map(np.asarray, ema))
    tckpt.save_checkpoint(str(root / "port" / "stage2"), 3, port, cfg=tc)
    no_ema = TrainState(net, dataclasses.replace(tc.train, ema_decay=None), 1)
    tckpt.save_checkpoint(str(root / "no_ema" / "stage2"), 0, no_ema, cfg=tc)
    key_map = _key_map(jax.tree_util.tree_map(np.asarray, state.params), every=1)
    with open(root / "map.json", "w") as f:
        json.dump(key_map, f)
    return root, key_map


@pytest.mark.parametrize("use_ema,mapped", [(False, False), (True, True)],
                         ids=["params-own_keys", "ema-key_map"])
def test_export_script_equals_jax_export_script(saved_both, tmp_path, monkeypatch, capsys,
                                                use_ema, mapped):
    root, key_map = saved_both
    extra = [*(["--use_ema"] if use_ema else []),
             *(["--key_map", str(root / "map.json")] if mapped else [])]
    jpth, tpth = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    _run_jax(monkeypatch, "export_torch", "--stage", "2", "--model_dir", str(root / "jax"),
             "--pth", jpth, *extra)
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    out = _script("export_pth_torch").main(
        ["--model_dir", str(root / "port"), "--pth", tpth, *extra, *CPU])
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert tline == jline.replace(jpth, tpth)
    want = torch.load(jpth, weights_only=True)
    got = torch.load(tpth, weights_only=True)
    assert sorted(got) == sorted(want) == sorted(out)
    if mapped:
        assert sorted(got) == sorted(key_map.values())
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    # the set asked for: the EMA differs from the params
    stem = key_map["encoder/stem/Conv_0/kernel"] if mapped else "encoder.stem.Conv_0.kernel"
    params = tckpt.load_params(str(root / "port" / "stage2"),
                               key="ema" if use_ema else "params")
    assert torch.equal(got[stem], params["encoder.stem.Conv_0.kernel"])


def test_export_script_without_an_ema_stops_naming_it(saved_both, tmp_path):
    root, _ = saved_both
    with pytest.raises(SystemExit, match="'ema'"):
        _script("export_pth_torch").main(
            ["--model_dir", str(root / "no_ema"), "--pth", str(tmp_path / "x.pth"),
             "--use_ema", *CPU])
    assert not os.path.exists(tmp_path / "x.pth")
