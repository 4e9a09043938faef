"""Training and eval from disk in the port against the JAX package, fp32
on the CPU, on a small KITTI-shaped corpus written here.

- One stage-1 and one stage-2 step (two steps each, the second after the
  first update) on a disk-fed batch: each package's loader, its wire
  decode and its augmentation under the values JAX's key splits draw,
  then each package's step from the same flax weights.  The batches
  agree as tests/test_torch_data.py holds them (depth and mask exact, RGB
  atol 1e-6); the loss terms within tests/test_torch_train.py's bound
  (atol 1e-4, rtol 1e-3).
- ``scripts/train_torch.py --dataset kitti`` on the CPU: a run stopped
  and ``--resume``-d ends bit for bit where an unbroken run does, fed
  from the decode cache, then from the device cache; ``--dataset nyu``
  trains and ``scripts/eval_torch.py`` scores both.
- The eval protocol on ``KittiEvalDataset`` (two raw sizes; PNG, .npy
  and velodyne GT) against ``gdn_tpu.evaluate``: atol/rtol 1e-5 on the
  continuous metrics, a1-a3 within one pixel of the sparsest image
  (tests/test_torch_evaluate.py's bound).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu import config as jcfg
from gdn_tpu import evaluate as JE
from gdn_tpu import metrics as JM
from gdn_tpu.checkpoint import transfer_stage1_decoder as j_transfer
from gdn_tpu.data import augment as JA
from gdn_tpu.data import kitti as JK
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.train import state as jstate
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch import evaluate as TE
from gdn_tpu_torch.checkpoint import params_from_flax, transfer_stage1_decoder
from gdn_tpu_torch.data import augment as TA
from gdn_tpu_torch.data import kitti as TK
from gdn_tpu_torch.data import pipeline as TP
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train import state as tstate
from gdn_tpu_torch.train import steps as tsteps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (16, 32)
SMALL = dict(image_size=HW, enc_channels=(8, 16), dec_channels=(16, 8), dtype="float32",
             use_pallas_gn=True)
AUG = dict(scale_range=(1.0, 1.2), jitter_strength=0.2)
EVAL_SIZES = [(37, 124), (40, 120)]
TOL = dict(atol=1e-5, rtol=1e-5)


def _write_calib(root):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "calib_cam_to_cam.txt"), "w") as f:
        f.write("R_rect_00: " + " ".join(map(str, np.eye(3).ravel())) + "\n")
        f.write("P_rect_02: 60 0 62 0 0 60 20 0 0 0 1 0\n")
    with open(os.path.join(root, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0.0 0.1 -0.05\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 pairs of 20x40 RGB with 16-bit depth PNGs whose depth follows
    the image (a ramp with boxes, as scripts/make_fixture.py --style
    scene draws), and an eval list of 6 images at two raw sizes with PNG,
    .npy and velodyne GT."""
    root = tmp_path_factory.mktemp("kitti_train")
    rng = np.random.default_rng(0)
    os.makedirs(root / "img")
    lines, evals = [], []
    for i in range(8):
        h, w = 20, 40
        depth = np.linspace(70, 5, h)[:, None] * rng.uniform(0.6, 1.0) * np.ones((1, w))
        y0, x0 = rng.integers(2, h - 6), rng.integers(2, w - 10)
        depth[y0:y0 + 5, x0:x0 + 8] = rng.uniform(3, 20)
        rgb = np.stack([1 / (0.3 + depth / 80), depth / 80, 0.5 + 0 * depth], -1)
        rgb = np.clip(rgb / rgb.max() + rng.normal(0, 0.05, rgb.shape), 0, 1)
        Image.fromarray((rgb * 255).astype(np.uint8)).save(root / "img" / f"{i}.png")
        sparse = np.where(rng.uniform(size=depth.shape) < 0.5, depth, 0.0)
        Image.fromarray(np.round(sparse * 256).astype(np.uint16)).save(
            root / "img" / f"{i}_d.png")
        lines.append(f"img/{i}.png img/{i}_d.png")
    _write_calib(str(root / "calib"))
    for i in range(6):
        hw = EVAL_SIZES[i % 2]
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(root / "img" / f"e{i}.png")
        gt = rng.uniform(0, 100, hw)
        gt[rng.uniform(size=hw) < 0.3] = 0.0
        if i % 3 == 0:
            Image.fromarray(np.round(gt * 256).astype(np.uint16)).save(
                root / "img" / f"e{i}_gt.png")
            evals.append(f"img/e{i}.png img/e{i}_gt.png")
        elif i % 3 == 1:
            np.save(root / "img" / f"e{i}_gt.npy", gt.astype(np.float32))
            evals.append(f"img/e{i}.png img/e{i}_gt.npy")
        else:
            pts = np.stack([rng.uniform(2, 60, 4000), rng.uniform(-12, 12, 4000),
                            rng.uniform(-3, 1, 4000), rng.uniform(0, 1, 4000)], -1)
            pts.astype(np.float32).tofile(root / "img" / f"e{i}.bin")
            evals.append(f"img/e{i}.png img/e{i}.bin")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "val.txt").write_text("\n".join(evals) + "\n")
    return str(root)


# ---------------------------------------------------- a disk-fed step

def _jax_params(key, b, data):
    """The values ``_augment_one`` draws for each of b samples."""
    out = {k: [] for k in TA.PARAMS}
    for kb in jax.random.split(key, b):
        k = jax.random.split(kb, 6)
        lo, hi = data.scale_range
        jk = jax.random.split(k[4], 3)
        j = data.jitter_strength
        vals = (jax.random.uniform(k[0], (), minval=lo, maxval=hi), jax.random.uniform(k[1], ()),
                jax.random.uniform(k[2], ()), jax.random.bernoulli(k[3]),
                *(jax.random.uniform(jk[i], (), minval=1.0 - j, maxval=1.0 + j)
                  for i in range(3)))
        for name, v in zip(TA.PARAMS, vals):
            out[name].append(float(v))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


def _disk_batches(corpus, n, seed=1):
    """n (JAX batch as numpy, port batch as tensors) pairs: each package
    loads batch i from disk, decodes its wire and augments it with the
    draws of key i."""
    kw = dict(size=HW, batch_size=4, seed=seed)
    jl, tl = iter(JK.KittiTrainDataset(corpus, "train.txt", **kw)), iter(
        TK.KittiTrainDataset(corpus, "train.txt", **kw))
    jdata, tdata = jcfg.DataConfig(**AUG), tcfg.DataConfig(**AUG)
    out = []
    for i in range(n):
        key = jax.random.PRNGKey(100 + i)
        jb = JA.decode_wire_batch({k: jnp.asarray(v) for k, v in next(jl).items()},
                                  max_depth=80.0, depth_scale=256.0)
        jb = {k: np.asarray(v) for k, v in JA.augment_batch(key, jb, jdata).items()}
        tb = TA.decode_wire_batch({k: TP.host_tensor(v) for k, v in next(tl).items()},
                                  max_depth=80.0, depth_scale=256.0)
        tb = TA.apply_augment(tb, _jax_params(key, 4, jdata), tdata)
        out.append((jb, tb))
    return out


def _cfgs():
    train = dict(lr=1e-3, steps_per_epoch=2, ckpt_dir="")
    j = jcfg.Config(model=jcfg.ModelConfig(**SMALL), train=jcfg.TrainConfig(**train),
                    data=jcfg.DataConfig(batch_size=4, **AUG))
    t = tcfg.Config(model=tcfg.ModelConfig(**SMALL), train=tcfg.TrainConfig(**train),
                    data=tcfg.DataConfig(batch_size=4, **AUG))
    return j, t


def _flax_sd(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _close_terms(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(float(got[k])), k
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-4, rtol=1e-3,
                                   err_msg=k)


@pytest.fixture(scope="module")
def stepped(corpus):
    """Two stage-1 steps, the decoder transfer, two stage-2 steps, in
    both packages, on disk-fed augmented batches."""
    batches = _disk_batches(corpus, 2)
    jc, tc = _cfgs()
    js = jstate.create_state(JDtoD(cfg=jc.model), (1, *HW, 1), jc.train, 2)
    d_net = DtoDNet(tc.model)
    d_net.load_state_dict(_flax_sd(js.params), strict=True)
    ts = tstate.TrainState(d_net, tc.train, 2)
    s1 = []
    for jb, tb in batches:
        js, jt = jsteps.make_stage1_step(jc)(js, jb)
        ts, tt = tsteps.make_stage1_step(tc)(ts, tb)
        s1.append((tt, jt))
    gs = jstate.create_state(JRtoD(cfg=jc.model), (1, *HW, 3), jc.train, 2,
                             freeze_decoder=True)
    g_init = _flax_sd(gs.params)
    gs = gs.replace(params=j_transfer(gs.params, js.params))
    g_net = RtoDNet(tc.model)
    g_net.load_state_dict(transfer_stage1_decoder(
        g_init, {k: v.clone() for k, v in d_net.state_dict().items()}), strict=True)
    d_net.requires_grad_(False)
    tg = tstate.TrainState(g_net, tc.train, 2, freeze_decoder=True)
    s2 = []
    for jb, tb in batches:
        gs, jt = jsteps.make_stage2_step(jc)(gs, js.params, jb)
        tg, tt = tsteps.make_stage2_step(tc)(tg, d_net, tb)
        s2.append((tt, jt))
    return dict(batches=batches, s1=s1, s2=s2)


def test_disk_fed_batches_agree(stepped):
    for jb, tb in stepped["batches"]:
        np.testing.assert_array_equal(tb["depth"].numpy(), jb["depth"])
        np.testing.assert_array_equal(tb["mask"].numpy(), jb["mask"])
        np.testing.assert_allclose(tb["rgb"].numpy(), jb["rgb"], atol=1e-6, rtol=0)
        assert 0 < jb["mask"].mean() < 1


@pytest.mark.parametrize("stage", ["s1", "s2"])
def test_disk_fed_steps_match_jax(stepped, stage):
    for got, want in stepped[stage]:
        _close_terms(got, want)


# --------------------------------------------------------------- the CLI

def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(state):
    return {k: v.clone() for k, v in state.net.state_dict().items()}


def test_train_script_resumes_from_disk_bit_for_bit(corpus, tmp_path, capsys):
    """4 steps unbroken against 2, a checkpoint, then --resume for 2
    more: the resumed loader and augmentation stream continue where the
    run stopped.  The unbroken run reads through the decode cache and
    validates on a pairs list; the resumed one keeps the corpus in a
    (CPU) device cache."""
    train = _load_script("train_torch")
    common = ["--dataset", "kitti", "--data_path", corpus, "--device", "cpu",
              "--dtype", "float32", "--height", str(HW[0]), "--width", str(HW[1]),
              "--batch_size", "3", "--steps_per_epoch", "2", "--log_every", "1",
              "--seed", "4"]
    whole = train.main(["--mode", "DtoD", *common, "--epochs", "2", "--ckpt_dir",
                        str(tmp_path / "a"), "--decode_cache", str(tmp_path / "cache"),
                        "--val_pairs_list", "train.txt", "--val_steps", "1"])
    first = train.main(["--mode", "DtoD", *common, "--epochs", "1", "--ckpt_dir",
                        str(tmp_path / "b"), "--device_cache"])
    resumed = train.main(["--mode", "DtoD", *common, "--epochs", "1", "--ckpt_dir",
                          str(tmp_path / "b"), "--device_cache", "--resume"])
    out = capsys.readouterr().out
    assert "resumed stage 1 at step 2" in out and "device_cache: 8 samples" in out
    assert "decoder native" in out or "decoder pil" in out
    assert "[stage1] step=4 val_" in out or "val_total" in out
    assert first.step == 2 and resumed.step == whole.step == 4
    a, b = _params(whole), _params(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not all(torch.equal(_params(first)[k], a[k]) for k in a)
    # stage 2 from disk, with in-training eval over the velodyne list
    two = train.main(["--mode", "RtoD", *common, "--epochs", "1", "--ckpt_dir",
                      str(tmp_path / "a"), "--eval_every", "1", "--eval_batch", "2",
                      "--calib_dir", os.path.join(corpus, "calib")])
    assert two.step == 2 and "eval_rmse" in capsys.readouterr().out
    ev = _load_script("eval_torch")
    res = ev.main(["--dataset", "kitti", "--data_path", corpus, "--calib_dir",
                   os.path.join(corpus, "calib"), "--device", "cpu", "--dtype", "float32",
                   "--ckpt_dir", str(tmp_path / "a"), "--eval_batch", "2", "--device_cache"])
    assert all(np.isfinite(res[k]) for k in JM.METRIC_NAMES)


@pytest.fixture(scope="module")
def nyu_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu_train")
    rng = np.random.default_rng(2)
    os.makedirs(root / "f")
    lines = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), np.uint8)).save(root / "f" / f"{i}.png")
        d = rng.uniform(0.3, 9.5, (480, 640))
        Image.fromarray(np.round(d * 1000).astype(np.uint16)).save(root / "f" / f"{i}_d.png")
        lines.append(f"f/{i}.png f/{i}_d.png")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def test_train_and_eval_scripts_on_nyu(nyu_corpus, tmp_path):
    train, ev = _load_script("train_torch"), _load_script("eval_torch")
    common = ["--dataset", "nyu", "--data_path", nyu_corpus, "--device", "cpu",
              "--dtype", "float32", "--height", "16", "--width", "24"]
    cfg = train.build_config(train.parse_args(common))
    assert (cfg.model.max_depth, cfg.data.dataset) == (10.0, "nyu")
    state = train.main(["--mode", "DtoD", *common, "--batch_size", "2", "--epochs", "1",
                        "--steps_per_epoch", "2", "--ckpt_dir", str(tmp_path)])
    assert state.step == 2
    res = ev.main([*common, "--stage", "1", "--val_list", "train.txt", "--ckpt_dir",
                   str(tmp_path), "--eval_batch", "2"])
    assert all(np.isfinite(res[k]) for k in JM.METRIC_NAMES)
    ecfg = ev.build_config(ev.parse_args(common))
    assert (ecfg.eval.cap, ecfg.eval.crop) == (10.0, "none")


# ------------------------------------------------------------- the protocol

def _j_forward(params, rgb):
    return 2.0 + 60.0 * jax.nn.sigmoid(3.0 * jnp.mean(rgb, axis=-1, keepdims=True) - 1.0)


def _t_forward(rgb):
    return 2.0 + 60.0 * torch.sigmoid(3.0 * rgb.float().mean(dim=-1, keepdim=True) - 1.0)


@pytest.mark.parametrize("gt_wire", ["f32", "u16"])
def test_evaluator_on_the_kitti_split_matches_jax(corpus, gt_wire):
    calib = os.path.join(corpus, "calib")
    cfgs = [c.Config(model=c.ModelConfig(image_size=HW, dtype="float32", use_pallas=False),
                     loss=c.LossConfig(use_pallas=False), train=c.TrainConfig(ckpt_dir=""),
                     eval=c.EvalConfig(batch_size=2, cap=80.0, crop="garg", gt_wire=gt_wire))
            for c in (jcfg, tcfg)]
    split = TK.KittiEvalDataset(corpus, "val.txt", HW, calib_dir=calib)
    want = JE.evaluate(cfgs[0], {}, _j_forward,
                       iter(JK.KittiEvalDataset(corpus, "val.txt", HW, calib_dir=calib)),
                       verbose=False)
    got = TE.evaluate(cfgs[1], _t_forward, split, verbose=False, device="cpu")
    cached = TE.evaluate(cfgs[1], _t_forward, split, verbose=False, device="cpu",
                         device_cache=True)
    samples = list(split)
    counts = [(((s["gt"][0] > 1e-3) & (s["gt"][0] < 80.0))
               & JM.crop_mask(*s["gt"].shape[1:], "garg")).sum() for s in samples]
    one_pixel = 1.0 / min(counts)
    for k in JM.METRIC_NAMES:
        atol = max(TOL["atol"], one_pixel) if k in ("a1", "a2", "a3") else TOL["atol"]
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=TOL["rtol"], err_msg=k)
        assert cached[k] == got[k], k
