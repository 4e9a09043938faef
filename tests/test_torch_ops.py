"""Resize ops of the PyTorch port against the JAX package (fp32).

The port is NCHW/OIHW, the JAX package NHWC/HWIO: inputs are made once
with numpy and transposed on the way in and out.  Tolerances are the
JAX suite's for the same ops (tests/test_ops.py): rtol 1e-6 / atol 1e-5
for the resizes, rtol 1e-4 / atol 1e-5 for the composed conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu.ops import resize as jr
from gdn_tpu_torch.ops import resize as tr


def _t(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _np(t):
    return t.permute(0, 2, 3, 1).numpy()


def _oihw(k_hwio):
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("hw,size", [
    ((8, 10), (16, 20)),  # exact 2x
    ((8, 10), (15, 19)),  # the odd-ladder resize of UpBlock
    ((4, 13), (8, 26)),
    ((5, 7), (9, 14)),
    ((1, 1), (2, 2)),
])
def test_resize_bilinear_matches_jax(hw, size):
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    got = _np(tr.resize_bilinear(_t(x), size))
    want = np.asarray(jr.resize_bilinear(jnp.asarray(x), size))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_resize_bilinear_keeps_dtype():
    x = torch.zeros(1, 3, 4, 4, dtype=torch.bfloat16)
    assert tr.resize_bilinear(x, (8, 8)).dtype == torch.bfloat16
    assert tr.resize_bilinear(x, (8, 8), precise=False).dtype == torch.bfloat16


@pytest.mark.parametrize("hw", [(3, 5), (6, 4)])
def test_up_v_up_h_match_jax(hw):
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tr._up_v(_t(x))),
                               np.asarray(jr._up_v(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tr._up_h(_t(x))),
                               np.asarray(jr._up_h(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_compose_bilinear_deconv_kernel_matches_jax():
    k3 = np.random.default_rng(2).normal(size=(3, 3, 4, 6)).astype(np.float32)
    got = tr.compose_bilinear_deconv_kernel(_oihw(k3)).numpy()
    want = np.asarray(jr.compose_bilinear_deconv_kernel(jnp.asarray(k3)))
    np.testing.assert_allclose(got, want.transpose(3, 2, 0, 1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(9, 13), (4, 13), (16, 52), (2, 2), (5, 2)])
def test_composed_resize_conv2x_matches_jax(hw):
    """Odd and even H, W >= 2: the composed transposed conv plus the
    thin-slab edge fix equals the JAX package's, and both equal
    conv3x3_SAME(resize_bilinear(x, 2x))."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w)
    x = rng.normal(size=(2, h, w, 6)).astype(np.float32)
    k3 = (rng.normal(size=(3, 3, 6, 4)) * 0.1).astype(np.float32)
    got = _np(tr.composed_resize_conv2x(_t(x), _oihw(k3)))
    assert got.shape == (2, 2 * h, 2 * w, 4)
    want = np.asarray(jr.composed_resize_conv2x(jnp.asarray(x), jnp.asarray(k3)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    up = jr.resize_bilinear(jnp.asarray(x), (2 * h, 2 * w))
    ref = jax.lax.conv_general_dilated(
        up, jnp.asarray(k3), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
