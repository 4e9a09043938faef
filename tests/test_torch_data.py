"""The port's data layer (gdn_tpu_torch/data) against the JAX package's
(gdn_tpu/data) on the same files and seeds, on the CPU.

- The loaders (KITTI and NYU, train and eval; wire and f32; native and
  PIL decode; looping and padded; ``seek``; the decode cache) yield the
  JAX loaders' batches bit for bit: both are numpy and PIL, and both
  bind the same native library.
- ``decode_wire_batch`` equals the JAX one exactly, at scale 256 and 1000.
- ``apply_augment``, fed the values that JAX's own key splits draw in
  ``_augment_one``, against ``gdn_tpu.data.augment.augment_batch``:
  depth and mask exact (nearest copies values, the zoom divides both
  sides alike), RGB within atol 1e-6 (a gather against a matrix product
  rounds the two-tap sums differently).
- The device cache on the CPU, the prefetch thread, the pipeline's
  seeded augmentation stream, ``make_loader`` and the refusals.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu import config as jcfg
from gdn_tpu.data import augment as JA
from gdn_tpu.data import cache as JC
from gdn_tpu.data import kitti as JK
from gdn_tpu.data import native_io as JN
from gdn_tpu.data import nyu as JNY
from gdn_tpu.data import velodyne as JV
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.data import augment as TA
from gdn_tpu_torch.data import cache as TC
from gdn_tpu_torch.data import kitti as TK
from gdn_tpu_torch.data import native_io as TN
from gdn_tpu_torch.data import nyu as TNY
from gdn_tpu_torch.data import pipeline as TP
from gdn_tpu_torch.data import velodyne as TV
from gdn_tpu_torch.data.batching import iter_batch_indices
from gdn_tpu_torch.data.device_cache import (
    DeviceResidentDataset, ShardedDeviceDataset, resident_bytes,
)
from gdn_tpu_torch.data.synthetic import SyntheticDataset, SyntheticEvalDataset, _image_seed

from torch_parallel_ranks import StubMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = 7  # not a multiple of the batch: a padded tail, a dropped one
RAW_HW = (40, 60)  # the PNGs' size; the loaders resize to TRAIN_HW
TRAIN_HW = (32, 48)
NYU_HW = (57, 76)
EVAL_SIZES = [(37, 124), (40, 120)]


@pytest.fixture(scope="module")
def native():
    """Whether native/libgdn_io.so loads (built at first use; asked in a
    fixture, not at import, so workers collecting this file build
    nothing)."""
    return TN.available() and JN.available()


# ---------------------------------------------------------------- corpora

def _write_calib(root):
    """Calibration files of a pinhole camera looking along velodyne x:
    u = 60 x_c / z + 62, v = 60 y_c / z + 20 (1-based pixels), with the
    axis swap x_v -> z_c, -y_v -> x_c, -z_v -> y_c."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\n")
        f.write("R_rect_00: " + " ".join(map(str, np.eye(3).ravel())) + "\n")
        p = np.array([[60.0, 0, 62, 0], [0, 60, 20, 0], [0, 0, 1, 0]])
        f.write("P_rect_02: " + " ".join(map(str, p.ravel())) + "\n")
    with open(os.path.join(root, "calib_velo_to_cam.txt"), "w") as f:
        f.write("calib_time: 15-Mar-2012 11:37:16\n")
        r = np.array([[0, -1.0, 0], [0, 0, -1.0], [1.0, 0, 0]])
        f.write("R: " + " ".join(map(str, r.ravel())) + "\n")
        f.write("T: 0.0 0.1 -0.05\n")


def _velo_points(rng, n=3000):
    """Points in front of the sensor, some behind it, and some repeated
    at other depths, so pixels are contested."""
    pts = np.stack([rng.uniform(-5, 60, n), rng.uniform(-12, 12, n),
                    rng.uniform(-3, 1, n), rng.uniform(0, 1, n)], -1)
    dup = pts[:200].copy()
    dup[:, 0] += rng.uniform(-3, 3, 200)
    return np.concatenate([pts, dup]).astype(np.float32)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """RGB PNGs at 40x60 with 16-bit depth PNGs (train.txt), the same
    RGB with .npy depth (train_npy.txt) and with 8-bit depth PNGs
    (train_u8.txt); an eval list at two raw sizes with PNG, .npy and
    velodyne GT, and its calibration."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    os.makedirs(root / "img")
    lines = {"train.txt": [], "train_npy.txt": [], "train_u8.txt": [], "val.txt": []}
    for i in range(N_PAIRS):
        Image.fromarray(rng.integers(0, 256, (*RAW_HW, 3), np.uint8)).save(
            root / "img" / f"{i}.png")
        d = rng.uniform(0, 90, RAW_HW)
        d[rng.uniform(size=RAW_HW) < 0.6] = 0.0  # sparse, and beyond the 80 m cap
        Image.fromarray(np.round(d * 256).astype(np.uint16)).save(root / "img" / f"{i}_d.png")
        np.save(root / "img" / f"{i}_d.npy", d.astype(np.float32))
        Image.fromarray(np.clip(d, 0, 255).astype(np.uint8)).save(root / "img" / f"{i}_d8.png")
        lines["train.txt"].append(f"img/{i}.png img/{i}_d.png")
        lines["train_npy.txt"].append(f"img/{i}.png img/{i}_d.npy")
        lines["train_u8.txt"].append(f"img/{i}.png img/{i}_d8.png")
    _write_calib(str(root / "calib"))
    for i in range(6):
        hw = EVAL_SIZES[i % 2]
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(root / "img" / f"e{i}.png")
        gt = rng.uniform(0, 100, hw)
        gt[rng.uniform(size=hw) < 0.3] = 0.0
        if i % 3 == 0:
            Image.fromarray(np.round(gt * 256).astype(np.uint16)).save(
                root / "img" / f"e{i}_gt.png")
            lines["val.txt"].append(f"img/e{i}.png img/e{i}_gt.png")
        elif i % 3 == 1:
            np.save(root / "img" / f"e{i}_gt.npy", gt.astype(np.float32))
            lines["val.txt"].append(f"img/e{i}.png img/e{i}_gt.npy")
        else:
            _velo_points(rng).tofile(root / "img" / f"e{i}.bin")
            lines["val.txt"].append(f"img/e{i}.png img/e{i}.bin")
    for name, ls in lines.items():
        (root / name).write_text("# a comment line\n" + "\n".join(ls) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    """480x640 RGB PNGs with millimetre 16-bit depth PNGs, and one pair
    with .npy depth, at NYU's raw size (the crop applies)."""
    root = tmp_path_factory.mktemp("nyu")
    rng = np.random.default_rng(1)
    os.makedirs(root / "f")
    lines, npy = [], []
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), np.uint8)).save(root / "f" / f"{i}.png")
        d = rng.uniform(0.2, 12, (480, 640))
        d[rng.uniform(size=d.shape) < 0.2] = 0.0
        Image.fromarray(np.round(d * 1000).astype(np.uint16)).save(root / "f" / f"{i}_d.png")
        np.save(root / "f" / f"{i}_d.npy", d.astype(np.float32))
        lines.append(f"f/{i}.png f/{i}_d.png")
        npy.append(f"f/{i}.png f/{i}_d.npy")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "train_npy.txt").write_text("\n".join(npy) + "\n")
    (root / "test.txt").write_text("\n".join(lines[:3] + npy[3:]) + "\n")
    return str(root)


def _equal_batches(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _take(loader, n):
    it = iter(loader)
    return [b for b, _ in zip(it, range(n))]


# ------------------------------------------------------------------ KITTI

@pytest.mark.parametrize("loop", [True, False], ids=["loop", "padded"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "pil"])
@pytest.mark.parametrize("wire", ["auto", "f32"])
def test_kitti_train_batches_match_jax(kitti_root, native, wire, use_native, loop):
    if use_native and not native:
        pytest.skip("native/libgdn_io.so does not build here")
    kw = dict(size=TRAIN_HW, batch_size=3, seed=3, loop=loop, use_native=use_native,
              wire=wire)
    port = TK.KittiTrainDataset(kitti_root, "train.txt", **kw)
    ref = JK.KittiTrainDataset(kitti_root, "train.txt", **kw)
    assert port._native == ref._native == use_native
    assert port.decoder == ("native" if use_native else "pil")
    n = 6 if loop else 3  # looping: across three shuffled passes
    got, want = _take(port, n), _take(ref, n)
    _equal_batches(got, want)
    if not loop:  # 7 = 3 + 3 + 1 real and 2 padded rows, masked out
        last = got[-1]
        if wire == "auto":
            assert last["depth"].dtype == np.uint16 and not last["depth"][1:].any()
        else:
            assert not last["mask"][1:].any() and last["mask"][0].any()


@pytest.mark.parametrize("wire", ["auto", "f32"])
def test_kitti_seek_resumes_the_jax_order(kitti_root, wire):
    kw = dict(size=TRAIN_HW, batch_size=2, seed=5, wire=wire)
    port = TK.KittiTrainDataset(kitti_root, "train.txt", **kw)
    ref = JK.KittiTrainDataset(kitti_root, "train.txt", **kw)
    unbroken = _take(port, 7)
    port.seek(4)
    ref.seek(4)
    resumed = _take(port, 3)
    _equal_batches(resumed, _take(ref, 3))
    _equal_batches(resumed, unbroken[4:])


@pytest.mark.parametrize("wire", ["auto", "f32"])
def test_kitti_decode_cache_matches_jax(kitti_root, tmp_path, wire):
    kw = dict(size=TRAIN_HW, batch_size=3, seed=2, wire=wire)
    port = TK.KittiTrainDataset(kitti_root, "train.txt", cache_dir=str(tmp_path / "p"), **kw)
    ref = JK.KittiTrainDataset(kitti_root, "train.txt", cache_dir=str(tmp_path / "j"), **kw)
    plain = TK.KittiTrainDataset(kitti_root, "train.txt", **kw)
    got = _take(port, 5)  # misses, then a pass of hits and misses
    _equal_batches(got, _take(ref, 5))
    if wire == "auto" or not plain._native:
        _equal_batches(got, _take(plain, 5))
    else:  # the native decoder's float RGB, quantized by the cache's uint8
        for g, w in zip(got, _take(plain, 5)):
            np.testing.assert_allclose(g["rgb"], w["rgb"], atol=1 / 510 + 1e-7, rtol=0)
            np.testing.assert_array_equal(g["depth"], w["depth"])
    assert port._cache.valid.all()
    for name in ("rgb.u8", "depth.u16", "valid.u8", "manifest.json"):
        with open(tmp_path / "p" / name, "rb") as a, open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("lst", ["train_npy.txt", "train_u8.txt"])
def test_native_gate_takes_pil_unless_every_depth_is_a_16_bit_png(kitti_root, lst):
    """An 8-bit PNG ends in .png but holds meters: the gate reads the bit
    depth, as the JAX package's does, and both fall back to PIL."""
    kw = dict(size=TRAIN_HW, batch_size=3, seed=1, loop=False)
    port = TK.KittiTrainDataset(kitti_root, lst, **kw)
    ref = JK.KittiTrainDataset(kitti_root, lst, **kw)
    assert not port._native and not ref._native
    assert TK._png_bit_depth(os.path.join(kitti_root, "img/0_d8.png")) == 8
    assert TK._png_bit_depth(os.path.join(kitti_root, "img/0_d.png")) == 16
    _equal_batches(list(port), list(ref))


def test_kitti_list_checks(kitti_root):
    (lambda p: open(p, "w").write("only_one_token\n"))(os.path.join(kitti_root, "bad.txt"))
    with pytest.raises(ValueError, match="<rgb> <depth>"):
        TK.KittiTrainDataset(kitti_root, "bad.txt")
    (lambda p: open(p, "w").write("# nothing\n"))(os.path.join(kitti_root, "empty.txt"))
    with pytest.raises(ValueError, match="empty list"):
        TK.KittiTrainDataset(kitti_root, "empty.txt")
    with pytest.raises(ValueError, match="never yield"):
        next(iter(TK.KittiTrainDataset(kitti_root, "train.txt", TRAIN_HW, batch_size=8)))
    assert TK.parse_list(os.path.join(kitti_root, "val.txt")) == JK.parse_list(
        os.path.join(kitti_root, "val.txt"))


def test_batch_indices_match_jax():
    from gdn_tpu.data.batching import iter_batch_indices as j_iter

    for n, b in ((5, 2), (4, 2), (7, 3), (2, 4)):
        order = np.random.default_rng(n).permutation(n)
        for loop in (True, False):
            got = list(iter_batch_indices(order, b, loop))
            want = list(j_iter(order, b, loop))
            assert [(list(i), p) for i, p in got] == [(list(i), p) for i, p in want]


def test_kitti_eval_split_matches_jax(kitti_root):
    """RGB at the train size, GT at its raw size from a 16-bit PNG, an
    .npy and a velodyne scan, sample for sample bit for bit."""
    calib = os.path.join(kitti_root, "calib")
    got = list(TK.KittiEvalDataset(kitti_root, "val.txt", TRAIN_HW, calib_dir=calib))
    want = list(JK.KittiEvalDataset(kitti_root, "val.txt", TRAIN_HW, calib_dir=calib))
    _equal_batches(got, want)
    assert [s["gt"].shape[1:] for s in got] == [EVAL_SIZES[i % 2] for i in range(6)]
    velo = got[2]["gt"]
    assert (velo > 0).sum() > 100  # the scan lands in the image
    with pytest.raises(ValueError, match="calib_dir"):
        list(TK.KittiEvalDataset(kitti_root, "val.txt", TRAIN_HW))


# ----------------------------------------------------------------- native

def test_native_io_matches_the_jax_binding(kitti_root, native, tmp_path):
    if not native:
        pytest.skip("native/libgdn_io.so does not build here")
    rgb = [os.path.join(kitti_root, f"img/{i}.png") for i in range(3)]
    dep = [os.path.join(kitti_root, f"img/{i}_d.png") for i in range(3)]
    for hw in (RAW_HW, TRAIN_HW, (50, 70)):
        np.testing.assert_array_equal(TN.decode_rgb_batch(rgb, *hw), JN.decode_rgb_batch(rgb, *hw))
        np.testing.assert_array_equal(TN.decode_depth_batch(dep, *hw),
                                      JN.decode_depth_batch(dep, *hw))
    np.testing.assert_array_equal(TN.decode_depth_batch(dep, *TRAIN_HW, scale=1e-3),
                                  JN.decode_depth_batch(dep, *TRAIN_HW, scale=1e-3))
    # at its own size the native decode is PIL's exactly
    pil = np.stack([TK.load_rgb(p) for p in rgb])
    np.testing.assert_allclose(TN.decode_rgb_batch(rgb, *RAW_HW), pil, atol=1e-6)
    with pytest.raises(RuntimeError, match="decode failed"):
        TN.decode_rgb_batch([str(tmp_path / "missing.png")], 8, 8)
    assert TN._SO_PATH == JN._SO_PATH


# ---------------------------------------------------------------- velodyne

def test_velodyne_projection_geometry():
    """tests/test_data.py's geometry on the port: a pinhole composed with
    the velodyne axis swap; the nearest point wins; behind the sensor
    is dropped."""
    f, cu, cv = 10.0, 50.0, 25.0
    swap = np.array([[0, -1.0, 0, 0], [0, 0, -1.0, 0], [1.0, 0, 0, 0], [0, 0, 0, 1.0]])
    proj = np.array([[f, 0, cu, 0], [0, f, cv, 0], [0, 0, 1.0, 0]]) @ swap
    both = np.array([[10.0, 0, 0, 1.0], [5.0, 0, 0, 1.0]])
    d = TV.depth_from_velodyne(both, proj, (50, 100))
    assert d[int(cv) - 1, int(cu) - 1] == pytest.approx(5.0)
    assert (d > 0).sum() == 1
    off = np.array([[5.0, -1.0, 0, 1.0]])
    d2 = TV.depth_from_velodyne(off, proj, (50, 100))
    assert d2[int(cv) - 1, int(round(f * 1 / 5 + cu)) - 1] == pytest.approx(5.0)
    assert TV.depth_from_velodyne(np.array([[-5.0, 0, 0, 1.0]]), proj, (50, 100)).sum() == 0.0


def test_velodyne_files_match_jax(kitti_root):
    calib = os.path.join(kitti_root, "calib")
    assert TV.read_calib_file(os.path.join(calib, "calib_cam_to_cam.txt")).keys() == {
        "R_rect_00", "P_rect_02"}
    np.testing.assert_array_equal(TV.projection_matrix(calib), JV.projection_matrix(calib))
    pts = _velo_points(np.random.default_rng(9))
    proj = TV.projection_matrix(calib)
    got = TV.depth_from_velodyne(pts, proj, (37, 124))
    np.testing.assert_array_equal(got, JV.depth_from_velodyne(pts, proj, (37, 124)))
    bin_path = os.path.join(kitti_root, "img/e2.bin")
    np.testing.assert_array_equal(TV.load_velodyne_points(bin_path),
                                  JV.load_velodyne_points(bin_path))
    np.testing.assert_array_equal(TV.depth_from_velodyne_files(bin_path, calib, (37, 124)),
                                  JV.depth_from_velodyne_files(bin_path, calib, (37, 124)))


# -------------------------------------------------------------------- NYU

@pytest.mark.parametrize("loop", [True, False], ids=["loop", "padded"])
@pytest.mark.parametrize("wire", ["auto", "f32"])
@pytest.mark.parametrize("lst", ["train.txt", "train_npy.txt"], ids=["png", "npy"])
def test_nyu_train_batches_match_jax(nyu_root, lst, wire, loop):
    kw = dict(size=NYU_HW, batch_size=2, seed=4, loop=loop, wire=wire)
    got = _take(TNY.NyuTrainDataset(nyu_root, lst, **kw), 4)
    _equal_batches(got, _take(JNY.NyuTrainDataset(nyu_root, lst, **kw), 4))
    if wire == "auto":
        assert got[0]["depth"].dtype == np.uint16


def test_nyu_decode_cache_and_seek_match_jax(nyu_root, tmp_path):
    kw = dict(size=NYU_HW, batch_size=2, seed=6, wire="f32")
    port = TNY.NyuTrainDataset(nyu_root, "train.txt", cache_dir=str(tmp_path / "p"), **kw)
    ref = JNY.NyuTrainDataset(nyu_root, "train.txt", cache_dir=str(tmp_path / "j"), **kw)
    _equal_batches(_take(port, 4), _take(ref, 4))
    port.seek(2)
    ref.seek(2)
    _equal_batches(_take(port, 2), _take(ref, 2))


def test_nyu_eval_split_and_crop_match_jax(nyu_root):
    got = list(TNY.NyuEvalDataset(nyu_root, "test.txt", NYU_HW))
    _equal_batches(got, list(JNY.NyuEvalDataset(nyu_root, "test.txt", NYU_HW)))
    assert got[0]["gt"].shape == (1, 426, 560) and got[0]["rgb"].shape == (1, *NYU_HW, 3)
    x = np.zeros((480, 640, 3))
    assert TNY.center_crop_nyu(x).shape == (426, 560, 3)
    assert TNY.center_crop_nyu(np.zeros((100, 100))).shape == (100, 100)
    p = os.path.join(nyu_root, "f/0_d.png")
    np.testing.assert_array_equal(TNY.load_nyu_depth(p, NYU_HW), JNY.load_nyu_depth(p, NYU_HW))


def test_nyu_labeled_mat_reader_matches_jax(tmp_path):
    import h5py

    rng = np.random.default_rng(7)
    p = str(tmp_path / "nyu_labeled.mat")
    with h5py.File(p, "w") as f:
        f.create_dataset("images", data=rng.integers(0, 255, (3, 3, 640, 480), dtype=np.uint8))
        f.create_dataset("depths", data=rng.uniform(0.5, 10, (3, 640, 480)).astype(np.float32))
    got = list(TNY.NyuLabeledMatDataset(p, NYU_HW, indices=[0, 2]))
    _equal_batches(got, list(JNY.NyuLabeledMatDataset(p, NYU_HW, indices=[0, 2])))
    assert len(got) == 2 and got[0]["gt"].shape == (1, 426, 560)


# ------------------------------------------------------------------ cache

def test_cache_persists_across_openings(kitti_root, tmp_path, monkeypatch):
    kw = dict(size=TRAIN_HW, batch_size=3, seed=0, loop=False, shuffle=False)
    first = list(TK.KittiTrainDataset(kitti_root, "train.txt", cache_dir=str(tmp_path), **kw))
    again = TK.KittiTrainDataset(kitti_root, "train.txt", cache_dir=str(tmp_path), **kw)
    assert again._cache.valid.all()

    def no_decode(idx):
        raise AssertionError("a warm cache decoded")

    monkeypatch.setattr(again, "_decode_wire", no_decode)
    _equal_batches(list(again), first)


def _cache(tmp_path, key="k", n=4):
    return TC.DecodedSampleCache(str(tmp_path), n, (4, 6), 256.0, key)


def test_cache_rebuilds_on_a_stale_manifest_or_truncated_files(tmp_path):
    c = _cache(tmp_path)
    c.write([0, 1], np.ones((2, 4, 6, 3), np.uint8), np.ones((2, 4, 6), np.uint16))
    c.rgb.flush()
    c.valid.flush()
    assert list(_cache(tmp_path).valid) == [1, 1, 0, 0]  # reopened: kept
    assert not _cache(tmp_path, key="other").valid.any()  # another corpus: rebuilt
    c = _cache(tmp_path)
    c.write([2], np.ones((1, 4, 6, 3), np.uint8), np.ones((1, 4, 6), np.uint16))
    c.valid.flush()
    with open(tmp_path / "depth.u16", "r+b") as f:
        f.truncate(10)
    rebuilt = _cache(tmp_path)
    assert not rebuilt.valid.any() and os.path.getsize(tmp_path / "depth.u16") == 4 * 4 * 6 * 2
    os.remove(tmp_path / "rgb.u8")
    assert not _cache(tmp_path).valid.any()
    with open(tmp_path / "manifest.json", "w") as f:
        f.write("{not json")
    assert not _cache(tmp_path).valid.any()
    want = json.load(open(tmp_path / "manifest.json"))
    assert want == {"n": 4, "height": 4, "width": 6, "depth_scale": 256.0, "key": "k"}
    assert TC.corpus_key([["a", "b"]], (4, 6), 256.0) == JC.corpus_key([["a", "b"]], (4, 6), 256.0)


def test_cache_directory_is_locked_against_another_process(tmp_path):
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time; sys.path.insert(0, sys.argv[1])\n"
         "from gdn_tpu_torch.data.cache import DecodedSampleCache\n"
         "DecodedSampleCache(sys.argv[2], 2, (4, 6), 256.0, 'k')\n"
         "print('held', flush=True); time.sleep(60)", REPO, str(tmp_path / "c")],
        stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        with pytest.raises(RuntimeError, match="locked by another process"):
            TC.DecodedSampleCache(str(tmp_path / "c"), 2, (4, 6), 256.0, "k")
    finally:
        holder.kill()
        holder.wait()
    # released with its process; this one takes it, and may open it again
    TC.DecodedSampleCache(str(tmp_path / "c"), 2, (4, 6), 256.0, "k")
    TC.DecodedSampleCache(str(tmp_path / "c"), 2, (4, 6), 256.0, "k")


# ---------------------------------------------------------- wire decode

@pytest.mark.parametrize("scale,max_depth", [(256.0, 80.0), (1000.0, 10.0)])
def test_decode_wire_batch_matches_jax_exactly(scale, max_depth):
    rng = np.random.default_rng(int(scale))
    rgb = rng.integers(0, 256, (3, 5, 7, 3), np.uint8)
    counts = rng.integers(0, 65536, (3, 5, 7, 1), np.uint16)
    counts[0, 0, :3, 0] = [0, 65535, int(max_depth * scale)]  # empty, top, the cap itself
    counts[2] = 0  # a padded row
    want = JA.decode_wire_batch({"rgb": jnp.asarray(rgb), "depth": jnp.asarray(counts)},
                                max_depth=max_depth, depth_scale=scale)
    host = {k: TP.host_tensor(v) for k, v in (("rgb", rgb), ("depth", counts))}
    assert host["depth"].dtype == torch.int16  # uint16 bits, carried as int16
    got = TA.decode_wire_batch(host, max_depth=max_depth, depth_scale=scale)
    for k in ("rgb", "depth", "mask"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert not got["mask"][2].any()
    # torch's own uint16 decodes the same; float batches pass through
    u16 = TA.decode_wire_batch({"rgb": host["rgb"], "depth": torch.from_numpy(counts)},
                               max_depth=max_depth, depth_scale=scale)
    np.testing.assert_array_equal(u16["depth"].numpy(), got["depth"].numpy())
    f32 = {"rgb": got["rgb"], "depth": got["depth"], "mask": got["mask"]}
    assert TA.decode_wire_batch(f32, max_depth=max_depth) == f32


# ------------------------------------------------------------ augmentation

def _jax_params(key, b, data):
    """The values ``_augment_one`` draws for each of b samples from
    ``key``, by the same key splits."""
    out = {k: [] for k in TA.PARAMS}
    for kb in jax.random.split(key, b):
        k = jax.random.split(kb, 6)
        lo, hi = data.scale_range
        s = jax.random.uniform(k[0], (), minval=lo, maxval=hi) if data.random_crop else 1.0
        flip = jax.random.bernoulli(k[3]) if data.random_flip else False
        jk = jax.random.split(k[4], 3)
        j = data.jitter_strength
        jit = [jax.random.uniform(jk[i], (), minval=1.0 - j, maxval=1.0 + j)
               if data.color_jitter else 1.0 for i in range(3)]
        for name, v in zip(TA.PARAMS, (s, jax.random.uniform(k[1], ()),
                                       jax.random.uniform(k[2], ()), flip, *jit)):
            out[name].append(float(v))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


def _aug_batch(seed, b=3, hw=(24, 36)):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0, 80, (b, *hw, 1)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.4] = 0.0
    return {"rgb": rng.uniform(0, 1, (b, *hw, 3)).astype(np.float32), "depth": depth,
            "mask": (depth > 0).astype(np.float32)}


AUG_CASES = {
    "zoom": dict(random_flip=False, color_jitter=False, scale_range=(1.0, 1.3)),
    "flip": dict(random_crop=False, color_jitter=False),
    "jitter": dict(random_crop=False, random_flip=False, jitter_strength=0.3),
    "all": dict(scale_range=(1.1, 1.4), jitter_strength=0.25),
    "off": dict(random_crop=False, random_flip=False, color_jitter=False),
}


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_apply_augment_with_jax_draws_matches_augment_batch(case):
    kw = AUG_CASES[case]
    jdata, tdata = jcfg.DataConfig(**kw), tcfg.DataConfig(**kw)
    batch = _aug_batch(len(case))
    key = jax.random.PRNGKey(17)
    want = JA.augment_batch(key, {k: jnp.asarray(v) for k, v in batch.items()}, jdata)
    params = _jax_params(key, 3, jdata)
    got = TA.apply_augment({k: torch.from_numpy(v) for k, v in batch.items()}, params, tdata)
    np.testing.assert_array_equal(got["depth"].numpy(), np.asarray(want["depth"]))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=1e-6, rtol=0)
    if case == "off":
        np.testing.assert_array_equal(got["depth"].numpy(), batch["depth"])


@pytest.mark.parametrize("s,oy,ox,flip", [
    (1.3, 0.0, 0.0, 0.0),  # the window at the top-left: coordinates below 0
    (1.3, 1.0, 1.0, 1.0),  # bottom-right, flipped: past the last pixel
    (1.07, 0.5, 0.25, 1.0),
])
def test_warp_at_chosen_values_matches_the_jax_warp(s, oy, ox, flip):
    """The warp at edge windows, against JAX's ``_warp_separable`` on the
    coordinates ``_augment_one`` computes from the same values."""
    data = tcfg.DataConfig(color_jitter=False)
    b = _aug_batch(7, b=1, hw=(21, 33))
    h, w = 21, 33
    js = jnp.float32(s)
    ys = jnp.float32(oy) * (h - h / js) + (jnp.arange(h, dtype=jnp.float32) + 0.5) / js - 0.5
    xs = jnp.float32(ox) * (w - w / js) + (jnp.arange(w, dtype=jnp.float32) + 0.5) / js - 0.5
    if flip:
        xs = (w - 1.0) - xs
    assert float(ys[0]) < 0 or oy > 0
    params = {k: torch.tensor([v], dtype=torch.float32) for k, v in zip(
        TA.PARAMS, (s, oy, ox, flip, 1.0, 1.0, 1.0))}
    tys, txs = TA._coords(params, h, w)
    np.testing.assert_array_equal(tys[0].numpy(), np.asarray(ys))
    np.testing.assert_array_equal(txs[0].numpy(), np.asarray(xs))
    got = TA.apply_augment({k: torch.from_numpy(v) for k, v in b.items()}, params, data)
    want_rgb = JA._warp_separable(jnp.asarray(b["rgb"][0]), ys, xs, nearest=False)
    want_d = JA._warp_separable(jnp.asarray(b["depth"][0]), ys, xs, nearest=True) / js
    np.testing.assert_allclose(got["rgb"][0].numpy(), np.asarray(want_rgb), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["depth"][0].numpy(), np.asarray(want_d))


def test_augment_params_are_seeded_and_follow_the_config():
    cfg = tcfg.DataConfig(scale_range=(1.0, 1.2), jitter_strength=0.2)
    a = TA.augment_params(torch.Generator().manual_seed(3), 64, cfg)
    b = TA.augment_params(torch.Generator().manual_seed(3), 64, cfg)
    assert all(torch.equal(a[k], b[k]) for k in TA.PARAMS)
    assert list(a) == list(TA.PARAMS) and all(v.shape == (64,) for v in a.values())
    assert 1.0 <= a["scale"].min() and a["scale"].max() < 1.2
    assert set(a["flip"].tolist()) == {0.0, 1.0}
    assert 0.8 <= a["brightness"].min() and a["saturation"].max() < 1.2
    off = TA.augment_params(torch.Generator().manual_seed(3), 4, tcfg.DataConfig(
        random_crop=False, random_flip=False, color_jitter=False))
    assert off["scale"].eq(1).all() and not off["flip"].any() and off["contrast"].eq(1).all()
    out = TA.apply_augment({k: torch.from_numpy(v) for k, v in _aug_batch(1).items()},
                           TA.augment_params(torch.Generator().manual_seed(0), 3, cfg), cfg)
    assert 0.0 <= out["rgb"].min() and out["rgb"].max() <= 1.0
    assert set(out["mask"].unique().tolist()) <= {0.0, 1.0}


# ------------------------------------------------------------ device cache

def _as_wire(batch):
    """A pipeline batch's tensors as the loader's numpy (int16 -> uint16)."""
    return {k: (v.numpy().view(np.uint16) if v.dtype == torch.int16 else v.numpy())
            for k, v in batch.items()}


@pytest.mark.parametrize("loop", [True, False], ids=["loop", "padded"])
def test_device_resident_dataset_matches_its_loader(kitti_root, loop):
    kw = dict(size=TRAIN_HW, batch_size=3, seed=8, loop=loop)
    cached = DeviceResidentDataset(TK.KittiTrainDataset(kitti_root, "train.txt", **kw),
                                   device="cpu")
    assert cached.resident_bytes == resident_bytes(N_PAIRS, *TRAIN_HW)
    assert cached.wire_depth_scale == 256.0 and len(cached) == N_PAIRS
    n = 5 if loop else 3
    got = [_as_wire(b) for b in _take(cached, n)]
    _equal_batches(got, _take(JK.KittiTrainDataset(kitti_root, "train.txt", **kw), n))
    cached.seek(2)
    _equal_batches([_as_wire(b) for b in _take(cached, 2)], got[2:4])


def test_device_resident_dataset_refusals(kitti_root, tmp_path):
    loader = TK.KittiTrainDataset(kitti_root, "train.txt", TRAIN_HW, batch_size=3)
    with pytest.raises(ValueError, match="GiB gate"):
        DeviceResidentDataset(loader, device="cpu", max_bytes=1000)
    with pytest.raises(ValueError, match="wire-format"):
        DeviceResidentDataset(TK.KittiTrainDataset(kitti_root, "train.txt", TRAIN_HW,
                                                   batch_size=3, wire="f32"), device="cpu")
    with pytest.raises(AssertionError, match="not divisible"):  # batch 3 over 2 ranks
        DeviceResidentDataset(loader, device="cpu", mesh=StubMesh(2))
    with pytest.raises(ValueError, match="requires a mesh"):
        ShardedDeviceDataset(loader, None)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedDeviceDataset(loader, StubMesh(2), device="cpu")
    # through a decode cache: the corpus warms it
    warm = TK.KittiTrainDataset(kitti_root, "train.txt", TRAIN_HW, batch_size=3,
                                cache_dir=str(tmp_path))
    DeviceResidentDataset(warm, device="cpu")
    assert warm._cache.valid.all()


# ---------------------------------------------------------------- pipeline

def test_prefetch_delivers_in_order_with_the_batch_index():
    def gen():
        for i in range(5):
            yield {"x": np.full((2,), i, np.float32), "d": np.full((2,), i, np.uint16)}

    seen = []

    def prepare(item, i):
        seen.append(i)
        return {k: TP.upload(v, torch.device("cpu")) for k, v in item.items()}

    got = list(TP.prefetch_to_device(gen(), size=2, device="cpu", prepare=prepare, start=10))
    assert [int(b["x"][0]) for b in got] == list(range(5)) and seen == list(range(10, 15))
    assert got[0]["d"].dtype == torch.int16 and isinstance(got[0]["x"], torch.Tensor)
    plain = list(TP.prefetch_to_device(gen(), size=1, device="cpu"))  # each leaf uploaded
    assert [int(b["x"][0]) for b in plain] == list(range(5)) and plain[0]["d"].dtype == torch.int16


def test_prefetch_passes_errors_to_the_consumer():
    def gen():
        yield {"x": np.zeros((1,), np.float32)}
        raise RuntimeError("decode failed")

    it = TP.prefetch_to_device(gen(), size=1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_prefetch_releases_its_thread_when_abandoned():
    produced = []
    before = threading.active_count()

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.full((1,), i, np.float32)}
            i += 1

    it = TP.prefetch_to_device(endless(), size=2, device="cpu")
    assert int(next(it)["x"][0]) == 0
    it.close()  # the consumer leaves
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert len(produced) <= 5  # the queue's size and the batches in hand, no more


def _pipe_cfg(**data):
    return tcfg.Config(model=tcfg.ModelConfig(image_size=TRAIN_HW, max_depth=80.0),
                       data=tcfg.DataConfig(batch_size=3, **data),
                       train=tcfg.TrainConfig(seed=9))


def test_train_pipeline_decodes_and_augments_with_seeded_draws(kitti_root):
    cfg = _pipe_cfg(scale_range=(1.0, 1.2))
    loader = TK.KittiTrainDataset(kitti_root, "train.txt", TRAIN_HW, batch_size=3, seed=9)
    got = _take(TP.make_train_pipeline(cfg, loader, device="cpu"), 4)
    ref = JK.KittiTrainDataset(kitti_root, "train.txt", TRAIN_HW, batch_size=3, seed=9)
    for i, (g, host) in enumerate(zip(got, _take(ref, 4))):
        want = TA.decode_wire_batch({k: TP.host_tensor(v) for k, v in host.items()},
                                    max_depth=80.0, depth_scale=256.0)
        params = TA.augment_params(torch.Generator().manual_seed(_image_seed(9, i)), 3,
                                   cfg.data)
        want = TA.apply_augment(want, params, cfg.data)
        for k in ("rgb", "depth", "mask"):
            assert torch.equal(g[k], want[k]), (i, k)
    # a resumed stream (the loader seeked, the draws skipped) is the tail
    loader.seek(2)
    tail = _take(TP.make_train_pipeline(cfg, loader, skip=2, device="cpu"), 2)
    for g, w in zip(tail, got[2:]):
        assert all(torch.equal(g[k], w[k]) for k in ("rgb", "depth", "mask"))
    # without augmentation: the wire decoded, nothing else
    loader.seek(0)
    plain = next(TP.make_train_pipeline(cfg, loader, augment=False, device="cpu"))
    ref.seek(0)
    host = next(iter(ref))
    np.testing.assert_array_equal(plain["rgb"].numpy(), host["rgb"] * np.float32(1 / 255))


def test_train_pipeline_over_the_device_cache_equals_host_fed(kitti_root):
    cfg = _pipe_cfg()
    mk = lambda: TK.KittiTrainDataset(kitti_root, "train.txt", TRAIN_HW, batch_size=3, seed=9)
    host = _take(TP.make_train_pipeline(cfg, mk(), device="cpu"), 3)
    cached = DeviceResidentDataset(mk(), device="cpu")
    dev = _take(TP.make_train_pipeline(cfg, cached, device="cpu"), 3)
    for a, b in zip(host, dev):
        assert all(torch.equal(a[k], b[k]) for k in ("rgb", "depth", "mask"))


def test_upload_to_the_cpu_copies_nothing_and_counts_nothing():
    before = TP.upload.bytes
    x = np.arange(6, dtype=np.uint16)
    t = TP.upload(x, torch.device("cpu"))
    assert t.dtype == torch.int16 and t.data_ptr() == x.ctypes.data
    assert TP.upload(t, torch.device("cpu")) is t and TP.upload.bytes == before


def test_cached_sample_iterable_replays_and_bounds_its_pass():
    reads = []

    def factory():
        reads.append(1)
        return ({"gt": np.full((1, 2), i, np.float32)} for i in range(5))

    c = TP.CachedSampleIterable(factory, max_items=3)
    first, second = list(c()), list(c())
    assert len(reads) == 1 and len(first) == len(second) == 3
    assert all(a["gt"] is b["gt"] for a, b in zip(first, second))
    big = TP.CachedSampleIterable(factory, max_bytes=10)
    assert len(list(big())) == 5 and len(list(big())) == 5 and len(reads) == 3


def test_make_loader_selects_and_refuses(kitti_root, nyu_root):
    def cfg(dataset, path, **data):
        return tcfg.Config(model=tcfg.ModelConfig(image_size=TRAIN_HW),
                           data=tcfg.DataConfig(dataset=dataset, data_path=path,
                                                batch_size=2, **data))

    assert isinstance(TP.make_loader(cfg("kitti", kitti_root)), TK.KittiTrainDataset)
    ev = TP.make_loader(cfg("kitti", kitti_root, calib_dir=os.path.join(kitti_root, "calib")),
                        "eval")
    assert isinstance(ev, TK.KittiEvalDataset) and ev.calib_dir.endswith("calib")
    ny = TP.make_loader(cfg("nyu", nyu_root), "train")
    assert isinstance(ny, TNY.NyuTrainDataset) and ny.wire_depth_scale == 1000.0
    assert isinstance(TP.make_loader(cfg("nyu", nyu_root, val_list="test.txt"), "eval"),
                      TNY.NyuEvalDataset)
    assert isinstance(TP.make_loader(cfg("synthetic", ""), device="cpu"), SyntheticDataset)
    assert isinstance(TP.make_loader(cfg("synthetic", ""), "eval", device="cpu"),
                      SyntheticEvalDataset)
    with pytest.raises(ValueError, match="bogus"):
        TP.make_loader(cfg("bogus", ""))
    from gdn_tpu_torch.data.grain_loader import GrainKittiDataset

    assert isinstance(TP.make_loader(cfg("kitti", kitti_root, loader="grain")),
                      GrainKittiDataset)
    with pytest.raises(ValueError, match="native loader only"):
        TP.make_loader(cfg("kitti", kitti_root, loader="grain", decode_cache="c"))
    with pytest.raises(ValueError, match="unknown loader 'bogus' \\(native\\|grain\\)"):
        tcfg.DataConfig(loader="bogus")
    assert tcfg.DataConfig(device_cache_sharded=True).device_cache_sharded  # A10
