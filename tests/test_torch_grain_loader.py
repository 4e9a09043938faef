"""The grain loader's counterpart (gdn_tpu_torch/data/grain_loader.py)
against the JAX package's grain loader and grain itself, on the CPU.

- ``index_shuffle`` equals grain's compiled ``index_shuffle_module`` on
  every index of small ranges and on samples of a large one, for three
  seeds (exact), and so does ``epoch_permutation``, the loader's form.
- The batches equal ``gdn_tpu.data.grain_loader.GrainKittiDataset``'s
  bit for bit over more than two epochs (the batch that straddles the
  boundary included): KITTI wire and f32, NYU, at worker_count 0 and 2
  (grain's worker processes on the JAX side, threads here).
- The cursor: ``state_dict_at`` under a prefetch offset,
  ``load_state_dict`` and ``seek`` resume to the unbroken run's next
  batches (at 4 threads too); ``seek`` raises where the JAX loader's
  does; the checkpoint's ``loader`` entry round-trips.
- ``make_loader`` routes ``loader="grain"`` and refuses the decode
  cache with it, and ``train_torch.py --loader grain --workers 2
  --resume`` continues bit for bit.

grain is the reference: it is imported inside the tests only
(``pytest.importorskip``), never by the port.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu_torch import checkpoint as tckpt
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.data import pipeline as TP
from gdn_tpu_torch.data.grain_loader import GrainKittiDataset, epoch_permutation, index_shuffle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = 7  # not a multiple of the batch: a batch straddles each epoch boundary
RAW_HW = (40, 60)
TRAIN_HW = (32, 48)
NYU_HW = (57, 76)
BATCH = 3
N_BATCHES = 6  # 18 positions: more than two epochs of 7


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """RGB PNGs with 16-bit depth PNGs (counts / 256 m), sparse and
    partly beyond the 80 m cap."""
    root = tmp_path_factory.mktemp("kitti_grain")
    rng = np.random.default_rng(0)
    os.makedirs(root / "img")
    lines = []
    for i in range(N_PAIRS):
        Image.fromarray(rng.integers(0, 256, (*RAW_HW, 3), np.uint8)).save(
            root / "img" / f"{i}.png")
        d = rng.uniform(0, 90, RAW_HW)
        d[rng.uniform(size=RAW_HW) < 0.6] = 0.0
        Image.fromarray(np.round(d * 256).astype(np.uint16)).save(root / "img" / f"{i}_d.png")
        lines.append(f"img/{i}.png img/{i}_d.png")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    """480x640 frames (the crop applies) with millimetre depth PNGs."""
    root = tmp_path_factory.mktemp("nyu_grain")
    rng = np.random.default_rng(1)
    os.makedirs(root / "f")
    lines = []
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), np.uint8)).save(
            root / "f" / f"{i}.png")
        d = rng.uniform(0.2, 12, (480, 640))
        d[rng.uniform(size=d.shape) < 0.2] = 0.0
        Image.fromarray(np.round(d * 1000).astype(np.uint16)).save(root / "f" / f"{i}_d.png")
        lines.append(f"f/{i}.png f/{i}_d.png")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def _take(loader, n):
    it = iter(loader)
    return [b for b, _ in zip(it, range(n))]


def _equal_batches(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _loaders(root, dataset, wire, workers, seed=3):
    grain_loader = pytest.importorskip("gdn_tpu.data.grain_loader")
    pytest.importorskip("grain")
    hw = NYU_HW if dataset == "nyu" else TRAIN_HW
    kw = dict(size=hw, batch_size=BATCH, seed=seed, max_depth=10.0 if dataset == "nyu" else 80.0,
              worker_count=workers, dataset=dataset, wire=wire)
    return (GrainKittiDataset(root, "train.txt", **kw),
            grain_loader.GrainKittiDataset(root, "train.txt", **kw))


# ------------------------------------------------------------ index_shuffle

@pytest.mark.parametrize("max_index", [0, 1, 2, 9, 31, 511, 1000, 2**20 - 1])
def test_index_shuffle_equals_grains_compiled_module(max_index):
    pytest.importorskip("grain")
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as ref,
    )

    if max_index < 2048:
        idx = np.arange(max_index + 1)
    else:  # a sample of the large range, its ends included
        idx = np.concatenate([[0, max_index], np.random.default_rng(0).integers(
            0, max_index + 1, 3000)])
    for seed in (0, 3, 2**32 - 1):
        got = index_shuffle(idx, max_index, seed)
        want = [ref.index_shuffle(int(i), max_index=max_index, seed=seed, rounds=4)
                for i in idx]
        np.testing.assert_array_equal(got, np.asarray(want, np.uint64),
                                      err_msg=f"seed {seed}")
        if max_index < 2048:  # a permutation of [0, max_index], also as a whole epoch
            assert sorted(got.tolist()) == list(range(max_index + 1))
            np.testing.assert_array_equal(epoch_permutation(max_index + 1, seed),
                                          np.asarray(want, np.int64))


def test_index_shuffle_refuses_odd_or_few_rounds():
    with pytest.raises(ValueError, match="rounds"):
        index_shuffle([0], 9, 0, rounds=3)
    with pytest.raises(ValueError, match="rounds"):
        index_shuffle([0], 9, 0, rounds=2)


# ---------------------------------------------------------------- batches

@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("dataset,wire", [("kitti", "auto"), ("kitti", "f32"),
                                          ("nyu", "auto")])
def test_batches_equal_the_jax_grain_loader(kitti_root, nyu_root, dataset, wire, workers):
    root = nyu_root if dataset == "nyu" else kitti_root
    port, jax_loader = _loaders(root, dataset, wire, workers)
    want = _take(jax_loader, N_BATCHES)
    _equal_batches(_take(port, N_BATCHES), want)
    assert port.wire_depth_scale == jax_loader.wire_depth_scale
    if workers > 1:  # seek works on one index stream only, in both packages
        for loader in (port, jax_loader):
            with pytest.raises(NotImplementedError, match="seek"):
                loader.seek(1)


def test_unshuffled_batches_equal_the_jax_grain_loader(kitti_root):
    grain_loader = pytest.importorskip("gdn_tpu.data.grain_loader")
    pytest.importorskip("grain")
    kw = dict(size=TRAIN_HW, batch_size=BATCH, shuffle=False, wire="f32")
    want = _take(grain_loader.GrainKittiDataset(kitti_root, "train.txt", **kw), N_BATCHES)
    _equal_batches(_take(GrainKittiDataset(kitti_root, "train.txt", **kw), N_BATCHES), want)


def test_record_order_is_grains(kitti_root, tmp_path):
    """At W=0 batch j holds positions jB..jB+B-1, across epochs; at W=2
    worker k batches positions k, k+2, ..., in turns (seed 3, 10
    records, B=3: grain's own first batches)."""
    lines = [f"img/{i % N_PAIRS}.png img/{i % N_PAIRS}_d.png" for i in range(10)]
    (tmp_path / "ten.txt").write_text("\n".join(lines) + "\n")
    os.symlink(os.path.join(kitti_root, "img"), tmp_path / "img")
    one = GrainKittiDataset(str(tmp_path), "ten.txt", TRAIN_HW, 3, seed=3)
    two = GrainKittiDataset(str(tmp_path), "ten.txt", TRAIN_HW, 3, seed=3, worker_count=2)
    rec = lambda ld, pos: ld.records(np.asarray(pos)).tolist()  # noqa: E731
    assert rec(one, [0, 1, 2]) == [4, 7, 0]
    assert rec(one, [9, 10, 11]) == [9, 6, 0]  # the last of epoch 0, two of epoch 1
    assert rec(two, [0, 2, 4]) == [4, 0, 2]


# ----------------------------------------------------------------- cursor

@pytest.mark.parametrize("workers", [0, 4])
def test_state_dict_at_under_a_prefetch_offset_resumes(kitti_root, workers):
    mk = lambda: GrainKittiDataset(kitti_root, "train.txt", TRAIN_HW, BATCH, seed=7,  # noqa
                                   worker_count=workers)
    unbroken = _take(mk(), N_BATCHES)
    src = mk()
    it = iter(src)
    for _ in range(4):  # the trainer consumed 2; a prefetch queue pulled 2 more
        next(it)
    state = src.state_dict_at(2)
    dst = mk()
    dst.load_state_dict(state, produced=2)
    _equal_batches(_take(dst, N_BATCHES - 2), unbroken[2:])
    assert dst.state_dict_at(2) == state  # the rebase point is logged
    with pytest.raises(ValueError, match="no recorded loader state"):
        dst.state_dict_at(1)
    # the raw cursor: what the next batch will be
    raw = mk()
    it = iter(raw)
    next(it)
    if workers:  # the threads decode ahead: the raw cursor runs ahead too
        assert json.loads(raw.state_dict())["next_positions"] != [0, 1, 2, 3]
    else:
        again = mk()
        again.load_state_dict(raw.state_dict(), produced=1)
        _equal_batches(_take(again, 2), unbroken[1:3])


def test_seek_resumes_at_one_stream_and_refuses_more(kitti_root):
    mk = lambda w=0: GrainKittiDataset(kitti_root, "train.txt", TRAIN_HW, BATCH, seed=7,  # noqa
                                       worker_count=w)
    unbroken = _take(mk(), N_BATCHES)
    for w in (0, 1):  # one index stream either way, as grain's worker_count 1
        ld = mk(w)
        ld.seek(3)
        _equal_batches(_take(ld, 3), unbroken[3:])
    with pytest.raises(NotImplementedError, match="seek"):
        mk(2).seek(3)


def test_load_state_dict_refuses_another_loader(kitti_root):
    a = GrainKittiDataset(kitti_root, "train.txt", TRAIN_HW, BATCH, seed=7)
    b = GrainKittiDataset(kitti_root, "train.txt", TRAIN_HW, BATCH, seed=8)
    with pytest.raises(ValueError, match="seed"):
        b.load_state_dict(a.state_dict())


def test_rebase_of_a_live_iterator_drops_batches_decoded_ahead(kitti_root):
    ld = GrainKittiDataset(kitti_root, "train.txt", TRAIN_HW, BATCH, seed=7, worker_count=2)
    unbroken = _take(GrainKittiDataset(kitti_root, "train.txt", TRAIN_HW, BATCH, seed=7,
                                       worker_count=2), 4)
    it = iter(ld)
    first = next(it)
    state = ld.state_dict_at(1)
    next(it), next(it)
    ld.load_state_dict(state, produced=1)
    _equal_batches([first, next(it), next(it)], unbroken[:3])


def test_checkpoint_loader_entry_round_trips(kitti_root, tmp_path):
    cfg = tcfg.Config(model=tcfg.ModelConfig(image_size=(16, 32)))
    from gdn_tpu_torch.train.loop import stage1_state

    state = stage1_state(cfg, "cpu")
    mk = lambda: GrainKittiDataset(kitti_root, "train.txt", TRAIN_HW, BATCH, seed=7,  # noqa
                                   worker_count=2)
    unbroken = _take(mk(), N_BATCHES)
    src = mk()
    _take(src, 4)
    entry = {"step": 3, "grain": src.state_dict_at(3)}
    tckpt.save_checkpoint(str(tmp_path), 3, state, loader_state=entry)
    back = tckpt.load_loader_state(str(tmp_path))
    assert back == entry
    dst = mk()
    dst.load_state_dict(back["grain"], produced=back["step"])
    _equal_batches(_take(dst, 3), unbroken[3:])


# ------------------------------------------------------------ the wiring

def test_make_loader_routes_grain_and_refuses_the_decode_cache(kitti_root, nyu_root):
    def cfg(dataset, path, **data):
        return tcfg.Config(model=tcfg.ModelConfig(image_size=TRAIN_HW),
                           data=tcfg.DataConfig(dataset=dataset, data_path=path, batch_size=2,
                                                loader="grain", **data))

    ld = TP.make_loader(cfg("kitti", kitti_root, grain_workers=3))
    assert isinstance(ld, GrainKittiDataset) and ld.worker_count == 3
    assert ld.wire_depth_scale == 256.0
    ny = TP.make_loader(cfg("nyu", nyu_root))
    assert isinstance(ny, GrainKittiDataset) and ny.wire_depth_scale == 1000.0
    with pytest.raises(ValueError, match="native loader only"):
        TP.make_loader(cfg("kitti", kitti_root, decode_cache="somewhere"))
    with pytest.raises(ValueError, match="on-disk dataset"):
        TP.make_loader(cfg("synthetic", ""), device="cpu")


def test_pipeline_over_the_grain_loader_equals_the_jax_batches(kitti_root):
    """make_train_pipeline decodes the grain loader's wire batches on the
    device as it decodes the native loader's (augmentation off)."""
    port, jax_loader = _loaders(kitti_root, "kitti", "auto", 0)
    cfg = tcfg.Config(model=tcfg.ModelConfig(image_size=TRAIN_HW),
                      data=tcfg.DataConfig(batch_size=BATCH))
    got = _take(TP.make_train_pipeline(cfg, port, augment=False, device="cpu"), 3)
    f32, _ = _loaders(kitti_root, "kitti", "f32", 0)
    want = _take(f32, 3)
    for g, w in zip(got, want):
        for k in ("rgb", "depth", "mask"):
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=0, atol=1e-6, err_msg=k)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_script_grain_resume_is_bit_for_bit(kitti_root, tmp_path):
    """train_torch.py --loader grain --workers 2: 4 steps unbroken against
    2 steps, a checkpoint with the grain cursor, and --resume for 2."""
    train = _load_script("train_torch")
    common = ["--mode", "DtoD", "--dataset", "kitti", "--data_path", kitti_root,
              "--loader", "grain", "--workers", "2", "--device", "cpu", "--dtype", "float32",
              "--height", str(TRAIN_HW[0]), "--width", str(TRAIN_HW[1]), "--batch_size", "2",
              "--steps_per_epoch", "2", "--log_every", "1"]
    whole = train.main([*common, "--epochs", "2", "--ckpt_dir", str(tmp_path / "whole")])
    train.main([*common, "--epochs", "1", "--ckpt_dir", str(tmp_path / "parts")])
    entry = tckpt.load_loader_state(str(tmp_path / "parts" / "stage1"))
    assert entry["step"] == 2 and json.loads(entry["grain"])["worker_count"] == 2
    resumed = train.main([*common, "--epochs", "1", "--ckpt_dir", str(tmp_path / "parts"),
                          "--resume"])
    assert whole.step == resumed.step == 4
    a, b = whole.net.state_dict(), resumed.net.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for sa, sb in zip(whole.optimizer.state.values(), resumed.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), k


def test_train_script_refuses_the_device_cache_with_grain(kitti_root, capsys):
    train = _load_script("train_torch")
    with pytest.raises(SystemExit):
        train.parse_args(["--dataset", "kitti", "--data_path", kitti_root, "--loader",
                          "grain", "--device_cache", "--device", "cpu"])
    assert "--device_cache requires --loader native" in capsys.readouterr().err


def test_grain_config_round_trips_through_the_jax_config(tmp_path):
    """A config with the grain loader written by the port reads back in
    the JAX package with the same data fields."""
    jcfg = pytest.importorskip("gdn_tpu.config")
    jckpt = pytest.importorskip("gdn_tpu.checkpoint")
    tc = tcfg.kitti_config(**{"data.loader": "grain", "data.grain_workers": 4})
    tckpt.save_config(str(tmp_path), tc)
    jc = jckpt.load_config(str(tmp_path))
    assert dataclasses.asdict(jc.data) == dataclasses.asdict(tc.data)
    assert jc == jcfg.kitti_config(**{"data.loader": "grain", "data.grain_workers": 4})
