"""GroupNorm+ELU of the PyTorch port against the JAX package.

On the CPU the port's ``group_norm_elu`` runs its plain version; it is
held to the TPU kernel run in interpret mode and to the analytic XLA
form, on the same numpy inputs, at the shapes and tolerances of
tests/test_kernels.py (fp32 rtol 1e-4 / atol 1e-5; bf16 atol 0.05, the
bound the JAX suite gives the kernel against its reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gdn_tpu.kernels.groupnorm import fused_group_norm_elu
from gdn_tpu.ops import groupnorm as jgn
from gdn_tpu_torch.kernels.groupnorm import group_norm_elu
from gdn_tpu_torch.ops import groupnorm as tgn

SHAPES = [  # (B, H, W, C, groups)
    (3, 10, 14, 16, 4),
    (2, 8, 12, 8, 4),
    (2, 16, 32, 32, 8),
    (1, 6, 8, 16, 8),
]
TOL = {
    "float32": dict(rtol=1e-4, atol=1e-5),
    "bfloat16": dict(rtol=0.05, atol=0.05),
}


def _inputs(shape, seed):
    b, h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    return x, scale, bias


def _torch_nchw(x_nhwc, dtype):
    """NHWC numpy -> NCHW-shaped channels_last torch tensor."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(getattr(torch, dtype))


def _np(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_group_norm_elu_matches_jax_kernel_and_analytic(shape, dtype):
    x, scale, bias = _inputs(shape, seed=sum(shape))
    groups = shape[-1]
    xt = _torch_nchw(x, dtype)
    out = group_norm_elu(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                         groups)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    assert out.is_contiguous(memory_format=torch.channels_last)

    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    kern = fused_group_norm_elu(xj, jnp.asarray(scale), jnp.asarray(bias),
                                groups, 1e-6, True)
    ana = jgn.group_norm_elu_analytic(xj, jnp.asarray(scale),
                                      jnp.asarray(bias), groups)
    got = _np(out)
    for ref in (kern, ana):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("impl", ["chanreduce", "grouped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_act_matches_jax(impl, dtype):
    import flax.linen as nn

    shape = SHAPES[0]
    x, scale, bias = _inputs(shape, seed=7)
    groups = shape[-1]
    got = tgn.group_norm_act(_torch_nchw(x, dtype), torch.from_numpy(scale),
                             torch.from_numpy(bias), groups, F.elu, impl)
    want = jgn.group_norm_act(jnp.asarray(x).astype(getattr(jnp, dtype)),
                              jnp.asarray(scale), jnp.asarray(bias), groups,
                              nn.elu, impl)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_plain_version_without_activation_matches_jax():
    shape = SHAPES[2]
    x, scale, bias = _inputs(shape, seed=3)
    got = tgn.group_norm_act(_torch_nchw(x, "float32"),
                             torch.from_numpy(scale), torch.from_numpy(bias),
                             shape[-1], None, "chanreduce")
    want = jgn.group_norm_act(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), shape[-1], None, "chanreduce")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_pick_groups_and_group_matrix_match_jax():
    for c in (1, 3, 8, 12, 16, 24, 32, 100, 512):
        for pref in (1, 4, 8, 16):
            assert tgn.pick_groups(c, pref) == jgn.pick_groups(c, pref)
    np.testing.assert_array_equal(tgn._group_matrix(32, 8),
                                  jgn._group_matrix(32, 8))


def test_degenerate_group_stays_finite():
    """A constant group has E[x^2] - mean^2 <= 0 by rounding: the clamp
    keeps rsqrt finite (the JAX package's round-1 NaN)."""
    x = torch.full((1, 8, 4, 4), 3.0).contiguous(memory_format=torch.channels_last)
    out = group_norm_elu(x, torch.ones(8), torch.zeros(8), 4)
    assert torch.isfinite(out).all()


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 12, 4, 4)
    one, zero = torch.ones(12), torch.zeros(12)
    with pytest.raises(ValueError, match="divisible"):
        group_norm_elu(x, one, zero, 5)
    with pytest.raises(ValueError, match="scale/bias"):
        group_norm_elu(x, torch.ones(6), zero, 4)
    with pytest.raises(ValueError, match="B, C, H, W"):
        group_norm_elu(x[0], one, zero, 4)
    with pytest.raises(TypeError, match="dtype"):
        group_norm_elu(x.half(), one, zero, 4)
    with pytest.raises(ValueError, match="device"):
        group_norm_elu(x.to("meta"), one, zero, 4)


def test_cpu_path_counts_no_launch():
    before = group_norm_elu.launches
    x = torch.randn(1, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    group_norm_elu(x, torch.ones(8), torch.zeros(8), 4)
    assert group_norm_elu.launches == before
