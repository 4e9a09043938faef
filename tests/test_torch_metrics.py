"""Metrics of the PyTorch port (gdn_tpu_torch/metrics.py) against the
JAX package's (gdn_tpu/metrics.py), fp32 on the CPU.

The port scores a batch at once: its functions reduce over the last two
axes, so a (B, H, W) batch gives (B,) columns; the JAX functions are
per image and run on each image alone.  Tolerance: atol 1e-5 / rtol 1e-5
on every metric (tests/test_parity_eval.py's bound; the two sum the same
masked maps in other orders).  Crops and indices compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import metrics as JM
from gdn_tpu_torch import metrics as TM

TOL = dict(atol=1e-5, rtol=1e-5)


def _maps(seed, b=3, hw=(24, 40), cap=80.0, hole=0.15):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, cap * 1.3, (b, *hw)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < hole] = 0.0
    pred = rng.uniform(0.5, cap * 1.2, (b, *hw)).astype(np.float32)
    return gt, pred


def _check_columns(got, want_per_image):
    for k in JM.METRIC_NAMES:
        col = got[k].numpy()
        for i, want in enumerate(want_per_image):
            np.testing.assert_allclose(col[i], np.asarray(want[k]), **TOL,
                                       err_msg=f"image {i} metric {k}")


def test_metric_names_match():
    assert TM.METRIC_NAMES == JM.METRIC_NAMES


@pytest.mark.parametrize("case", ["random", "tied", "empty_mask", "float_mask"])
def test_compute_errors_matches_jax(case):
    gt, pred = _maps(1)
    mask = (gt > 1e-3) & (gt < 80.0)
    if case == "tied":  # pred equal to gt on some images and pixels
        pred[0] = gt[0]
        pred[1, ::2] = gt[1, ::2]
        gt[2, :, :] = 7.0
    if case == "empty_mask":
        mask[1] = False
    pred = np.clip(pred, 1e-3, 80.0)
    m = mask.astype(np.float32) if case == "float_mask" else mask
    got = TM.compute_errors(torch.from_numpy(gt), torch.from_numpy(pred),
                            torch.from_numpy(m))
    want = [JM.compute_errors(jnp.asarray(gt[i]), jnp.asarray(pred[i]), jnp.asarray(m[i]))
            for i in range(len(gt))]
    _check_columns(got, want)
    if case == "tied":
        assert float(got["abs_rel"][0]) == 0.0 and float(got["a1"][0]) == 1.0
    if case == "empty_mask":
        assert all(float(got[k][1]) == 0.0 for k in TM.METRIC_NAMES)


def test_compute_errors_per_image_map_gives_scalars():
    gt, pred = _maps(2, b=1)
    mask = gt > 1e-3
    got = TM.compute_errors(torch.from_numpy(gt[0]), torch.from_numpy(pred[0]),
                            torch.from_numpy(mask[0]))
    want = JM.compute_errors(jnp.asarray(gt[0]), jnp.asarray(pred[0]), jnp.asarray(mask[0]))
    for k in TM.METRIC_NAMES:
        assert got[k].dim() == 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL)


def test_apply_cap_matches_jax():
    gt, pred = _maps(3)
    for lo, hi in ((1e-3, 80.0), (1e-3, 50.0), (0.5, 10.0)):
        g, p, m = TM.apply_cap(torch.from_numpy(gt), torch.from_numpy(pred), lo, hi)
        jg, jp, jm = JM.apply_cap(jnp.asarray(gt), jnp.asarray(pred), lo, hi)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


@pytest.mark.parametrize("crop", ["garg", "eigen", "none"])
@pytest.mark.parametrize("hw", [(375, 1242), (93, 311), (75, 100), (128, 416), (7, 9)])
def test_crop_mask_matches_jax(crop, hw):
    np.testing.assert_array_equal(TM.crop_mask(*hw, crop), JM.crop_mask(*hw, crop))


def test_crop_mask_refuses_unknown():
    with pytest.raises(ValueError, match="unknown crop"):
        TM.crop_mask(8, 8, "center")


@pytest.mark.parametrize("case", ["random", "tied", "even", "empty"])
def test_masked_median_matches_jax(case):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 50, (4, 9, 11)).astype(np.float32)
    mask = rng.uniform(size=x.shape) < 0.6
    if case == "tied":
        x = np.round(x / 10.0).astype(np.float32)  # few distinct values
    if case == "even":
        mask[:] = False
        mask[:, :2, :3] = True  # 6 pixels: the lower-middle one
    if case == "empty":
        mask[2] = False
    got = TM.masked_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = [float(JM.masked_median(jnp.asarray(x[i]), jnp.asarray(mask[i])))
            for i in range(len(x))]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_median_scale_scales_the_raw_prediction():
    """The ratio is taken on the RAW pred, clipped after scaling; an
    empty mask keeps scale 1."""
    gt, _ = _maps(5, cap=80.0)
    mask = (gt > 1e-3) & (gt < 80.0)
    # an unscaled predictor: most of its values beyond the cap
    pred = (gt * 3.0 + 1.0).astype(np.float32)
    mask[2] = False
    got = TM.median_scale(torch.from_numpy(pred), torch.from_numpy(gt),
                          torch.from_numpy(mask), 1e-3, 80.0).numpy()
    for i in range(len(gt)):
        want = JM.median_scale(jnp.asarray(pred[i]), jnp.asarray(gt[i]),
                               jnp.asarray(mask[i]), 1e-3, 80.0)
        np.testing.assert_allclose(got[i], np.asarray(want), **TOL)
    np.testing.assert_array_equal(got[2], np.clip(pred[2], 1e-3, 80.0))
    clipped_first = TM.median_scale(torch.from_numpy(np.clip(pred, 1e-3, 80.0)),
                                    torch.from_numpy(gt), torch.from_numpy(mask),
                                    1e-3, 80.0).numpy()
    assert np.abs(clipped_first[0] - got[0]).max() > 1.0


@pytest.mark.parametrize("median_scaling", [False, True])
@pytest.mark.parametrize("crop,cap", [("garg", 80.0), ("eigen", 50.0), ("none", 10.0)])
def test_evaluate_prediction_matches_jax(crop, cap, median_scaling):
    gt, pred = _maps(6, hw=(40, 130), cap=cap)
    got = TM.evaluate_prediction(torch.from_numpy(gt), torch.from_numpy(pred), cap=cap,
                                 crop=crop, median_scaling=median_scaling)
    want = [JM.evaluate_prediction(jnp.asarray(gt[i]), jnp.asarray(pred[i]), cap=cap,
                                   crop=crop, median_scaling=median_scaling)
            for i in range(len(gt))]
    _check_columns(got, want)


def test_metric_accumulator_matches_jax():
    rng = np.random.default_rng(7)
    ta, ja = TM.MetricAccumulator(), JM.MetricAccumulator()
    for _ in range(5):
        m = {k: float(v) for k, v in zip(TM.METRIC_NAMES, rng.uniform(0, 3, 8))}
        ta.update(m)
        ja.update(m)
    assert ta.count == ja.count == 5
    assert ta.result() == ja.result()
    assert ta.table() == ja.table()
    assert TM.MetricAccumulator().result() == JM.MetricAccumulator().result()
