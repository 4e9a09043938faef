"""The port's fused conv3x3+GroupNorm+ELU family against the JAX package.

On the CPU the port's entry points (``gdn_tpu_torch/kernels/conv_gn_elu.py``,
``kernels/fusion_bt.py``) run their plain PyTorch versions inside the
same autograd Functions the CUDA kernels run in; the JAX package's
Pallas kernels run in interpret mode with "float32" taps, exactly as
tests/test_kernels.py and tests/test_fusion_bt.py run them.  Both sides
get the same arrays from a seeded numpy generator: the JAX side NHWC
activations and HWIO weights, the port NCHW-shaped channels_last
activations and OIHW weights.

Tolerances are the JAX suite's for the same kernels: forward and
residuals rtol 1e-4 / atol 1e-5, gradients of sum(o * cos(arange))
rtol 1e-3 / atol 1e-5 (fp32, sums in other orders); the bf16 cases
rtol 0.1 / atol 0.06 (tests/test_fusion_bt.py: bf16 taps and stores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu.kernels import conv_gn_elu as jk
from gdn_tpu.kernels import fusion_bt as jf
from gdn_tpu_torch.kernels import conv_gn_elu as tk
from gdn_tpu_torch.kernels import fusion_bt as tf

EPS = 1e-6
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=0.1, atol=0.06)

# (b, h, w, cin, cout, groups, batch tile of the TPU kernel)
BT_SHAPES = [
    (4, 8, 16, 32, 32, 8, 2), (4, 6, 12, 64, 64, 8, 4), (2, 8, 16, 128, 128, 8, 2),
    (4, 8, 16, 32, 64, 8, 2), (4, 5, 16, 16, 16, 4, 2),
]
S2_SHAPES = [
    (4, 8, 16, 32, 32, 8, 2), (4, 8, 16, 32, 64, 8, 2), (4, 6, 12, 64, 128, 8, 2),
    (2, 8, 16, 128, 128, 8, 2), (4, 8, 16, 16, 32, 4, 4),
]
# (b, h, w, cx, cl, cout, groups, batch tile)
FB_SHAPES = [
    (4, 8, 16, 32, 32, 32, 8, 2), (4, 6, 12, 64, 64, 64, 8, 4),
    (2, 8, 16, 128, 128, 128, 8, 2), (4, 8, 16, 16, 32, 16, 4, 2),
    (4, 5, 16, 32, 64, 32, 8, 2),
]


def _data(seed, b, h, w, cin, cout):
    """x NHWC, w HWIO, scale, bias: the JAX suite's ``_convgn_data``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, cout).astype(np.float32),
            rng.normal(size=cout).astype(np.float32) * 0.1)


def _fb_data(seed, b, h, w, cx, cl, cout):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cx)).astype(np.float32),
            rng.normal(size=(b, h, w, cl)).astype(np.float32),
            rng.normal(size=(3, 3, cx, cout)).astype(np.float32) * 0.1,
            rng.normal(size=(3, 3, cl, cout)).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, cout).astype(np.float32),
            rng.normal(size=cout).astype(np.float32) * 0.1)


def _to_torch(a, dtype=torch.float32):
    """numpy -> the port's layout: NHWC -> NCHW-shaped channels_last,
    HWIO -> OIHW, vectors as they are; leaves that require grad."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dim() == 4 and t.shape[0] == 3 and t.shape[1] == 3:
        t = t.permute(3, 2, 0, 1).contiguous()
    elif t.dim() == 4:
        t = t.permute(0, 3, 1, 2).to(dtype)
    return t.requires_grad_(True)


def _from_torch(t, like):
    """A port tensor or gradient back in the JAX side's layout."""
    t = t.detach().float()
    if like.ndim == 4 and like.shape[:2] == (3, 3):
        t = t.permute(2, 3, 1, 0)
    elif like.ndim == 4:
        t = t.permute(0, 2, 3, 1)
    return t.numpy()


def _cos(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float32)).reshape(shape)


def _compare(j_fn, t_fn, arrays, fwd=FWD):
    """Forward (at ``fwd``) and the gradients of sum(o * cos(arange)) in
    every input (at GRAD), the JAX function on NHWC arrays against the
    port's on its layout."""
    j_in = [jnp.asarray(a) for a in arrays]
    want = np.asarray(j_fn(*j_in))
    cos = _cos(want.shape)
    t_in = [_to_torch(a) for a in arrays]
    out = t_fn(*t_in)
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_from_torch(out, want), want, **fwd)
    j_grads = jax.grad(lambda *a: jnp.sum(j_fn(*a) * cos),
                       argnums=tuple(range(len(arrays))))(*j_in)
    loss = (out.permute(0, 2, 3, 1) * torch.from_numpy(cos)).sum()
    t_grads = torch.autograd.grad(loss, t_in)
    for a, jg, tg in zip(arrays, j_grads, t_grads):
        np.testing.assert_allclose(_from_torch(tg, a), np.asarray(jg), **GRAD)


def _compare_residuals(j_res, t_res):
    for name, j, t in zip(("a", "yn", "inv"), j_res, t_res):
        j = np.asarray(j)
        np.testing.assert_allclose(_from_torch(t, j), j, err_msg=name, **FWD)


# ------------------------------------------------- against the JAX kernels

def test_fused_conv_gn_elu_matches_jax_kernel():
    arrays = _data(0, 2, 10, 14, 16, 16)
    _compare(lambda *a: jk.fused_conv_gn_elu(*a, 4, EPS, True),
             lambda *a: tk.fused_conv_gn_elu(*a, 4, EPS, "float32"), arrays)
    out = tk.fused_conv_gn_elu(*[_to_torch(a, torch.bfloat16) for a in arrays], 4)
    assert out.dtype == torch.float32  # fp32 out whatever x's dtype


def test_fused_conv_gn_elu_bf16_taps_gradients_match_jax_kernel():
    """bf16 taps on fp32 inputs: the forward rounds x and w to bf16, the
    backward does not.  The JAX kernel's VJP is that of its fp32
    reference on the unrounded inputs, so the gradients agree at the fp32
    bound although the forwards agree only at the bf16 one."""
    _compare(lambda *a: jk.fused_conv_gn_elu(*a, 4, EPS, True, "bfloat16"),
             lambda *a: tk.fused_conv_gn_elu(*a, 4, EPS, "bfloat16"),
             _data(12, 2, 10, 14, 16, 16), fwd=BF16)


@pytest.mark.parametrize("b,h,w,cin,cout,groups,t", BT_SHAPES)
def test_fused_conv_gn_elu_bt_matches_jax_kernel(b, h, w, cin, cout, groups, t):
    arrays = _data(1, b, h, w, cin, cout)
    _compare(lambda *a: jk.fused_conv_gn_elu_bt(*a, groups, EPS, t, True, "float32"),
             lambda *a: tk.fused_conv_gn_elu_bt(*a, groups, EPS, "float32"), arrays)
    _compare_residuals(
        jk._conv_gn_elu_bt_all(*map(jnp.asarray, arrays), groups, EPS, t, True,
                               "float32"),
        tk._conv_gn_elu_bt_all(*map(_to_torch, arrays), groups, EPS, "float32"))


@pytest.mark.parametrize("b,h,w,cin,cout,groups,t", S2_SHAPES)
def test_fused_conv_gn_elu_s2_matches_jax_kernel(b, h, w, cin, cout, groups, t):
    arrays = _data(2, b, h, w, cin, cout)
    _compare(lambda *a: jk.fused_conv_gn_elu_s2(*a, groups, EPS, t, True, "float32"),
             lambda *a: tk.fused_conv_gn_elu_s2(*a, groups, EPS, "float32"), arrays)
    _compare_residuals(
        jk._conv_gn_elu_s2_all(*map(jnp.asarray, arrays), groups, EPS, t, True,
                               "float32"),
        tk._conv_gn_elu_s2_all(*map(_to_torch, arrays), groups, EPS, "float32"))


@pytest.mark.parametrize("b,h,w,cx,cl,cout,groups,t", FB_SHAPES)
def test_fused_fusion_bt_matches_jax_kernel(b, h, w, cx, cl, cout, groups, t):
    arrays = _fb_data(3, b, h, w, cx, cl, cout)
    _compare(lambda *a: jf.fused_fusion_bt(*a, groups, EPS, t, True, "float32"),
             lambda *a: tf.fused_fusion_bt(*a, groups, EPS, "float32"), arrays)
    _compare_residuals(
        jf._fusion_bt_all(*map(jnp.asarray, arrays), groups, EPS, t, True, "float32"),
        tf._fusion_bt_all(*map(_to_torch, arrays), groups, EPS, "float32"))


@pytest.mark.parametrize("kind", ["v1", "bt", "s2", "fusion"])
def test_bf16_matches_jax_bf16_kernel(kind):
    """bf16 activations and bf16 taps on both sides (the v1 kernel takes
    its activations in fp32, as its call site gives them)."""
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    if kind == "fusion":
        x, lat, wx, wl, s, bi = _fb_data(4, 4, 8, 16, 32, 32, 32)
        want = jf.fused_fusion_bt(bf(x), bf(lat), wx, wl, s, bi, 8, EPS, 2, True,
                                  "bfloat16")
        got = tf.fused_fusion_bt(_to_torch(x, torch.bfloat16),
                                 _to_torch(lat, torch.bfloat16), _to_torch(wx),
                                 _to_torch(wl), _to_torch(s), _to_torch(bi), 8, EPS,
                                 "bfloat16")
    else:
        x, w, s, bi = _data(5, 4, 8, 16, 32, 32)
        xt = _to_torch(x, torch.float32 if kind == "v1" else torch.bfloat16)
        args = (_to_torch(w), _to_torch(s), _to_torch(bi), 8, EPS, "bfloat16")
        if kind == "v1":
            want = jk.fused_conv_gn_elu(jnp.asarray(x), w, s, bi, 8, EPS, True,
                                        "bfloat16")
            got = tk.fused_conv_gn_elu(xt, *args)
        elif kind == "bt":
            want = jk.fused_conv_gn_elu_bt(bf(x), w, s, bi, 8, EPS, 2, True, "bfloat16")
            got = tk.fused_conv_gn_elu_bt(xt, *args)
        else:
            want = jk.fused_conv_gn_elu_s2(bf(x), w, s, bi, 8, EPS, 2, True, "bfloat16")
            got = tk.fused_conv_gn_elu_s2(xt, *args)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_from_torch(got, want), want, **BF16)


@pytest.mark.parametrize("b,h,w,cin,cout,groups", [
    (2, 9, 13, 16, 32, 8),   # odd H and W: SAME pads (1, 1) at both
    (3, 7, 12, 8, 16, 4),    # odd H, even W: (1, 1) rows, (0, 1) columns
    (2, 29, 38, 5, 6, 3),    # NYU's 57x76 -> 29x38 step, ragged channels
])
def test_fused_conv_gn_elu_s2_odd_sizes_match_jax_reference(b, h, w, cin, cout, groups):
    """The TPU kernel's gate refuses odd sizes; the port runs them, so
    the reference here is the JAX package's strided ``_reference``."""
    arrays = _data(6, b, h, w, cin, cout)
    _compare(lambda *a: jk._reference(*a, groups, EPS, strides=(2, 2)),
             lambda *a: tk.fused_conv_gn_elu_s2(*a, groups, EPS, "float32"), arrays)
    out = tk.fused_conv_gn_elu_s2(*map(_to_torch, arrays), groups, EPS, "float32")
    assert tuple(out.shape) == (b, cout, -(-h // 2), -(-w // 2))


# ----------------------------------- analytic backward vs plain autograd

def _grads(fn, tensors, cot):
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    assert out.grad_fn is not None
    return out, torch.autograd.grad(out, leaves, cot)


@pytest.mark.parametrize("kind,dtype", [
    ("v1", "float32"), ("bt", "float32"), ("s2", "float32"), ("fusion", "float32"),
    ("bt", "bfloat16"), ("s2", "bfloat16"), ("fusion", "bfloat16"),
])
def test_function_backward_matches_autograd_of_plain(kind, dtype):
    """Each entry point's autograd Function against autograd through its
    plain version.  fp32: rtol 1e-4 / atol 1e-5 (the same math, other
    orders).  bf16: within 2% of each gradient's largest magnitude (the
    analytic form rounds its elementwise chain to bf16; the plain graph
    stays fp32 until its output)."""
    dt = getattr(torch, dtype)
    stride = 2 if kind == "s2" else 1
    if kind == "fusion":
        arrays = _fb_data(7, 2, 7, 9, 12, 20, 16)
        fused = lambda *a: tf.fused_fusion_bt(*a, 4, EPS, dtype)
        plain = lambda *a: tf.fusion_bt_plain(*a, 4, EPS, dtype)[0]
    else:
        arrays = _data(8, 2, 7, 9, 12, 16)
        fused = {"v1": tk.fused_conv_gn_elu, "bt": tk.fused_conv_gn_elu_bt,
                 "s2": tk.fused_conv_gn_elu_s2}[kind]
        fused = (lambda f: lambda *a: f(*a, 4, EPS, dtype))(fused)
        out_dt = torch.float32 if kind == "v1" else None
        plain = lambda *a: tk.conv_gn_elu_plain(*a, 4, EPS, stride, dtype, out_dt)[0]
    tensors = [_to_torch(a, dt) for a in arrays]
    probe = fused(*tensors)
    cot = torch.from_numpy(_cos(tuple(probe.shape))).to(probe.dtype)
    out, got = _grads(fused, tensors, cot)
    ref, want = _grads(plain, tensors, cot)
    assert torch.equal(out, ref)  # the same forward on the CPU
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
        else:
            err = (g.float() - w.float()).abs().max().item()
            assert err <= 0.02 * w.float().abs().max().item(), err


def test_frozen_weights_get_no_gradient_and_inputs_still_do():
    """Stage 2 freezes the decoder: the fusion's weights need no
    gradient, its inputs do."""
    x, lat, wx, wl, s, bi = (_to_torch(a) for a in _fb_data(9, 2, 6, 8, 8, 4, 8))
    for t in (wx, wl, s, bi):
        t.requires_grad_(False)
    out = tf.fused_fusion_bt(x, lat, wx, wl, s, bi, 4, EPS, "float32")
    out.sum().backward()
    assert x.grad is not None and lat.grad is not None
    assert wx.grad is None and wl.grad is None


# ------------------------------------------------------ wrappers' checks

def test_no_grad_path_keeps_no_graph_and_counts_no_launch_on_cpu():
    before = (tk.fused_conv_gn_elu_bt.launches, tf.fused_fusion_bt.launches)
    arrays = [_to_torch(a).detach() for a in _data(10, 1, 5, 6, 4, 8)]
    out = tk.fused_conv_gn_elu_bt(*arrays, 4, EPS, "float32")
    assert out.grad_fn is None and not out.requires_grad
    assert (tk.fused_conv_gn_elu_bt.launches, tf.fused_fusion_bt.launches) == before


@pytest.mark.parametrize("case", ["groups", "weight", "dtype", "tap", "lateral"])
def test_wrappers_refuse_bad_arguments(case):
    x, w, s, bi = (_to_torch(a).detach() for a in _data(11, 1, 5, 6, 4, 8))
    if case == "groups":
        with pytest.raises(ValueError, match="divisible"):
            tk.fused_conv_gn_elu_bt(x, w, s, bi, 3)
    elif case == "weight":
        with pytest.raises(ValueError, match="must be"):
            tk.fused_conv_gn_elu_s2(x, w[:, :3], s, bi, 4)
    elif case == "dtype":
        with pytest.raises(TypeError, match="not supported"):
            tk.fused_conv_gn_elu(x.double(), w, s, bi, 4)
    elif case == "tap":
        with pytest.raises(ValueError, match="tap_dtype"):
            tk.fused_conv_gn_elu_bt(x, w, s, bi, 4, EPS, "float16")
    else:
        with pytest.raises(ValueError, match="does not match"):
            tf.fused_fusion_bt(x, x[:, :, :4], w, w, s, bi, 4)


def test_pack_weight_layout_and_rounding():
    w = torch.randn(6, 5, 3, 3, generator=torch.Generator().manual_seed(0))
    packed = tk.pack_weight(w, torch.bfloat16)
    assert packed.shape == (9, 5, 6) and packed.dtype == torch.float32
    assert packed.is_contiguous()
    want = w.to(torch.bfloat16).float()
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(packed[ky * 3 + kx], want[:, :, ky, kx].t())
    assert [tk.block_rows(c) for c in (8, 16, 17, 32, 33, 512)] == [
        256, 256, 128, 128, 64, 64]
