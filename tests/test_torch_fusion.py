"""The port's ``use_pallas_fusion`` path against the JAX package: the
upsample kernel's and the per-image fusion-block kernel's entry points
(``gdn_tpu_torch/kernels/upsample.py``, ``kernels/fusion_block.py``),
and both nets with the flag on.

On the CPU the port's entry points run their plain PyTorch versions
inside the autograd Function the CUDA kernels run in; the JAX package's
Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them.  Both sides get the same arrays from a seeded numpy generator: the
JAX side NHWC activations and HWIO weights, the port NCHW-shaped
channels_last activations and OIHW weights.

Tolerances are the JAX suite's for these kernels: forward rtol 1e-4 /
atol 1e-5, gradients of sum(o * cos(arange)) rtol 1e-3 / atol 1e-5
(fp32, sums in other orders); forward with bf16 taps rtol 0.1 / atol
0.06 (tests/test_fusion_bt.py), the gradients with bf16 taps at the fp32
bound again: both backwards are the VJP of the fp32 reference on the
unrounded inputs.  Whole nets: depth rtol 1e-4 / atol 1e-3 m, features
rtol 1e-4 / atol 1e-4 (tests/test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu.checkpoint import params_to_torch
from gdn_tpu.kernels import fusion_block as jfb
from gdn_tpu.kernels import upsample as jup
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.ops.resize import resize_bilinear as j_resize
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import params_from_flax
from gdn_tpu_torch.kernels import conv_gn_elu as tk
from gdn_tpu_torch.kernels import fusion_block as tfb
from gdn_tpu_torch.kernels import upsample as tup
from gdn_tpu_torch.kernels.groupnorm import group_norm_elu
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.models import blocks as tb
from gdn_tpu_torch.ops.conv import conv_same
from gdn_tpu_torch.ops.resize import (
    composed_resize_conv2x, resize_bilinear, upsample2x_bilinear,
)

EPS = 1e-6
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=0.1, atol=0.06)

# (b, h, w, cin, cout, groups): W = 13 (2W % 8 != 0); H = 1 with
# Cout < 8 * groups; W = 1; the plain case
UP_SHAPES = [(2, 4, 13, 16, 16, 4), (2, 1, 6, 8, 8, 4), (1, 5, 1, 8, 16, 8),
             (2, 4, 8, 32, 16, 8)]
# (b, h, w, cx, cl, cout, groups): W = 13; H = 1 with Cout < 8 * groups;
# Cx != Cl
FB_SHAPES = [(2, 4, 13, 16, 16, 16, 4), (2, 1, 6, 8, 8, 8, 4), (2, 6, 8, 16, 32, 16, 8)]

# a five-scale net, narrow: at 32x64 every UpBlock is an exact 2x and the
# coarsest goes from 1x2; at 30x38 (15x19, 8x10, 4x5, 2x3, 1x2) only
# 4x5 -> 8x10 and 15x19 -> 30x38 are
DEEP = dict(enc_channels=(8, 8, 16, 16, 16), dec_channels=(16, 16, 8, 8, 8),
            use_pallas_gn=True)


def _up_data(seed, b, h, w, cin, cout):
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
    if t.dim() == 4 and t.shape[:2] == (3, 3):
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
    assert out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_from_torch(out, want), want, **fwd)
    j_grads = jax.grad(lambda *a: jnp.sum(j_fn(*a) * cos),
                       argnums=tuple(range(len(arrays))))(*j_in)
    loss = (out.permute(0, 2, 3, 1) * torch.from_numpy(cos)).sum()
    t_grads = torch.autograd.grad(loss, t_in)
    for a, jg, tg in zip(arrays, j_grads, t_grads):
        np.testing.assert_allclose(_from_torch(tg, a), np.asarray(jg), **GRAD)


# ------------------------------------------------- against the JAX kernels

@pytest.mark.parametrize("tap", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cin,cout,groups", UP_SHAPES)
def test_fused_upsample_conv_matches_jax_kernel(b, h, w, cin, cout, groups, tap):
    _compare(lambda *a: jup.fused_upsample_conv(*a, groups, EPS, True, tap),
             lambda *a: tup.fused_upsample_conv(*a, groups, EPS, tap),
             _up_data(0, b, h, w, cin, cout), FWD if tap == "float32" else BF16)


@pytest.mark.parametrize("tap", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cx,cl,cout,groups", FB_SHAPES)
def test_fused_fusion_block_matches_jax_kernel(b, h, w, cx, cl, cout, groups, tap):
    _compare(lambda *a: jfb.fused_fusion_block(*a, groups, EPS, True, tap),
             lambda *a: tfb.fused_fusion_block(*a, groups, EPS, tap),
             _fb_data(1, b, h, w, cx, cl, cout), FWD if tap == "float32" else BF16)


@pytest.mark.parametrize("kind", ["upsample", "fusion_block"])
def test_bf16_inputs_give_fp32_out_and_match_jax(kind):
    """bf16 activations as the bf16 model hands them over (the JAX call
    sites cast them to fp32 first, which is exact), bf16 taps."""
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)
    if kind == "upsample":
        x, w, s, bi = _up_data(2, 2, 4, 6, 16, 16)
        want = jup.fused_upsample_conv(bf(x), w, s, bi, 4, EPS, True, "bfloat16")
        got = tup.fused_upsample_conv(_to_torch(x, torch.bfloat16), _to_torch(w),
                                      _to_torch(s), _to_torch(bi), 4, EPS, "bfloat16")
    else:
        x, lat, wx, wl, s, bi = _fb_data(3, 2, 4, 6, 16, 8, 16)
        want = jfb.fused_fusion_block(bf(x), bf(lat), wx, wl, s, bi, 4, EPS, True,
                                      "bfloat16")
        got = tfb.fused_fusion_block(
            _to_torch(x, torch.bfloat16), _to_torch(lat, torch.bfloat16), _to_torch(wx),
            _to_torch(wl), _to_torch(s), _to_torch(bi), 4, EPS, "bfloat16")
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(_from_torch(got, want), want, **BF16)


# ------------------------------------------ the plain versions' identities

@pytest.mark.parametrize("b,h,w,c", [(2, 4, 13, 5), (2, 1, 6, 3), (1, 5, 1, 4), (1, 1, 1, 2)])
def test_upsample2x_bilinear_equals_resize_bilinear(b, h, w, c):
    x = np.random.default_rng(4).normal(size=(b, h, w, c)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), (2 * h, 2 * w)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for got in (upsample2x_bilinear(xt), resize_bilinear(xt, (2 * h, 2 * w))):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,h,w,cin,cout,groups", [(2, 4, 13, 16, 16, 4),
                                                   (2, 2, 2, 8, 8, 4)])
def test_upsample_conv_plain_equals_the_unfused_routes(b, h, w, cin, cout, groups):
    """resize_bilinear + conv + GroupNorm+ELU, and the composed
    transposed-conv route, compute the same function."""
    x, k, s, bi = (_to_torch(a).detach() for a in _up_data(5, b, h, w, cin, cout))
    want = tup.upsample_conv_plain(x, k, s, bi, groups, EPS, "float32")
    assert tuple(want.shape) == (b, cout, 2 * h, 2 * w) and want.dtype == torch.float32
    routes = {
        "resize": conv_same(resize_bilinear(x, (2 * h, 2 * w)), k),
        "composed": composed_resize_conv2x(x, k),
    }
    for name, y in routes.items():
        got = group_norm_elu(y.contiguous(memory_format=torch.channels_last), s, bi,
                             groups, EPS)
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name, **FWD)
    ref = tup.upsample_conv_reference(x, k, s, bi, groups, EPS)
    np.testing.assert_allclose(ref.numpy(), want.numpy(), **FWD)


def test_fusion_block_plain_equals_concat_conv():
    x, lat, wx, wl, s, bi = (_to_torch(a).detach() for a in _fb_data(6, 2, 5, 7, 8, 4, 8))
    want = tfb.fusion_block_plain(x, lat, wx, wl, s, bi, 4, EPS, "float32")
    y = conv_same(torch.cat([x, lat], 1), torch.cat([wx, wl], 1))
    got = group_norm_elu(y.contiguous(memory_format=torch.channels_last), s, bi, 4, EPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)


def test_bf16_taps_round_the_upsampled_map_not_x():
    """The tap dtype applies to U: an x that bf16 holds exactly still
    gives another result than fp32 taps, because its blends are not
    bf16 values."""
    x, k, s, bi = _up_data(7, 1, 3, 4, 8, 8)
    xt = _to_torch(x, torch.bfloat16).detach()
    k16 = _to_torch(k).detach().to(torch.bfloat16).float()  # weights bf16 already
    s, bi = _to_torch(s).detach(), _to_torch(bi).detach()
    a32 = tup.upsample_conv_plain(xt, k16, s, bi, 4, EPS, "float32")
    a16 = tup.upsample_conv_plain(xt, k16, s, bi, 4, EPS, "bfloat16")
    assert not torch.equal(a32, a16)
    u = upsample2x_bilinear(xt.float()).to(torch.bfloat16).float()
    want = tk.conv_gn_elu_plain(u, k16, s, bi, 4, EPS, 1, "float32", torch.float32)[0]
    assert torch.equal(a16, want)


# --------------------------------- the Functions' backward and the checks

def _grads(fn, tensors, cot, frozen=()):
    leaves = [t.detach().clone().requires_grad_(i not in frozen)
              for i, t in enumerate(tensors)]
    out = fn(*leaves)
    assert out.grad_fn is not None
    live = [t for t in leaves if t.requires_grad]
    return out, torch.autograd.grad(out, live, cot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["v1", "upsample", "fusion_block"])
def test_function_backward_is_the_vjp_of_the_fp32_reference(kind, dtype):
    """Whatever the tap dtype, the gradients are those of autograd
    through the fp32 reference on the same inputs (rtol 1e-4 / atol
    1e-5: the same math; the upsample's reference resizes through one
    interpolate call, the plain version through shifted blends)."""
    if kind == "fusion_block":
        arrays = _fb_data(8, 2, 5, 7, 12, 20, 16)
        fused = lambda *a: tfb.fused_fusion_block(*a, 4, EPS, dtype)
        ref = lambda *a: tfb.fusion_block_plain(*a, 4, EPS, "float32")
    elif kind == "upsample":
        arrays = _up_data(9, 2, 5, 7, 12, 16)
        fused = lambda *a: tup.fused_upsample_conv(*a, 4, EPS, dtype)
        ref = lambda *a: tup.upsample_conv_plain(*a, 4, EPS, "float32")
    else:
        arrays = _up_data(10, 2, 5, 7, 12, 16)
        fused = lambda *a: tk.fused_conv_gn_elu(*a, 4, EPS, dtype)
        ref = lambda *a: tk.conv_gn_elu_plain(*a, 4, EPS, 1, "float32", torch.float32)[0]
    tensors = [_to_torch(a) for a in arrays]
    probe = fused(*tensors)
    cot = torch.from_numpy(_cos(tuple(probe.shape)))
    out, got = _grads(fused, tensors, cot)
    want_out, want = _grads(ref, tensors, cot)
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), want_out.detach().numpy(), **FWD)
    else:
        assert not torch.equal(out, want_out)  # the forward did round
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["upsample", "fusion_block"])
def test_bf16_inputs_get_bf16_input_gradients(kind):
    if kind == "upsample":
        arrays, n_act = _up_data(11, 1, 3, 4, 8, 8), 1
        fused = lambda *a: tup.fused_upsample_conv(*a, 4, EPS, "bfloat16")
    else:
        arrays, n_act = _fb_data(12, 1, 3, 4, 8, 4, 8), 2
        fused = lambda *a: tfb.fused_fusion_block(*a, 4, EPS, "bfloat16")
    tensors = [_to_torch(a, torch.bfloat16) for a in arrays]
    out = fused(*tensors)
    grads = torch.autograd.grad(out.sum(), tensors)
    assert out.dtype == torch.float32
    assert [g.dtype for g in grads] == [torch.bfloat16] * n_act + [torch.float32] * (
        len(tensors) - n_act)


@pytest.mark.parametrize("kind", ["upsample", "fusion_block"])
def test_frozen_weights_get_no_gradient_and_inputs_still_do(kind):
    """Stage 2 freezes the decoder: its weights need no gradient, the
    activations that reach it do, and they are the full run's."""
    if kind == "upsample":
        arrays, n_act = _up_data(13, 2, 3, 4, 8, 8), 1
        fused = lambda *a: tup.fused_upsample_conv(*a, 4, EPS, "float32")
    else:
        arrays, n_act = _fb_data(14, 2, 3, 4, 8, 4, 8), 2
        fused = lambda *a: tfb.fused_fusion_block(*a, 4, EPS, "float32")
    tensors = [_to_torch(a) for a in arrays]
    cot = torch.from_numpy(_cos(tuple(fused(*tensors).shape)))
    _, full = _grads(fused, tensors, cot)
    frozen = tuple(range(n_act, len(tensors)))
    _, part = _grads(fused, tensors, cot, frozen)
    assert len(part) == n_act
    for g, w in zip(part, full):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
    for t in tensors[n_act:]:
        t.requires_grad_(False)
    fused(*tensors).sum().backward()
    assert all(t.grad is not None for t in tensors[:n_act])
    assert all(t.grad is None for t in tensors[n_act:])


def test_no_grad_path_keeps_no_graph_and_counts_no_launch_on_cpu():
    before = (tup.fused_upsample_conv.launches, tfb.fused_fusion_block.launches)
    assert before == (0, 0)
    up = [_to_torch(a).detach() for a in _up_data(15, 1, 3, 4, 4, 8)]
    fb = [_to_torch(a).detach() for a in _fb_data(16, 1, 3, 4, 4, 4, 8)]
    for out in (tup.fused_upsample_conv(*up, 4), tfb.fused_fusion_block(*fb, 4)):
        assert out.grad_fn is None and not out.requires_grad
    with torch.no_grad():
        live = [t.clone().requires_grad_(True) for t in up]
        assert tup.fused_upsample_conv(*live, 4).grad_fn is None
    assert (tup.fused_upsample_conv.launches, tfb.fused_fusion_block.launches) == before


@pytest.mark.parametrize("case", ["groups", "weight", "dtype", "tap", "lateral", "rank"])
def test_wrappers_refuse_bad_arguments(case):
    x, w, s, bi = (_to_torch(a).detach() for a in _up_data(17, 1, 5, 6, 4, 8))
    if case == "groups":
        with pytest.raises(ValueError, match="divisible"):
            tup.fused_upsample_conv(x, w, s, bi, 3)
    elif case == "weight":
        with pytest.raises(ValueError, match="must be"):
            tup.fused_upsample_conv(x, w[:, :3], s, bi, 4)
    elif case == "dtype":
        with pytest.raises(TypeError, match="not supported"):
            tup.fused_upsample_conv(x.double(), w, s, bi, 4)
    elif case == "tap":
        with pytest.raises(ValueError, match="tap_dtype"):
            tfb.fused_fusion_block(x, x, w, w, s, bi, 4, EPS, "float16")
    elif case == "lateral":
        with pytest.raises(ValueError, match="does not match"):
            tfb.fused_fusion_block(x, x[:, :, :4], w, w, s, bi, 4)
    else:
        with pytest.raises(ValueError, match="must be"):
            tup.fused_upsample_conv(x[0], w, s, bi, 4)


# -------------------------------------------------------------- whole nets

def _cfgs(hw, dtype="float32", **flags):
    kw = dict(DEEP, image_size=hw, dtype=dtype, **flags)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


_PARAMS = {}


def _net_params(hw, channels):
    """Flax weights of the five-scale RtoDNet (3 channels) or DtoDNet (1)."""
    if (hw, channels) not in _PARAMS:
        jc, _ = _cfgs(hw)
        net = (JRtoD if channels == 3 else JDtoD)(cfg=jc)
        x = np.zeros((1, *hw, channels), np.float32)
        init = jax.jit(lambda x: net.init(jax.random.PRNGKey(0), x))
        _PARAMS[hw, channels] = jax.tree_util.tree_map(np.asarray, init(x)["params"])
    return _PARAMS[hw, channels]


def _port(module, params):
    module.load_state_dict(params_from_flax(params), strict=True)
    return module


def _count_calls(monkeypatch):
    """Count the fused wrappers as ``models.blocks`` calls them; upsample
    calls are recorded with their input (H, W)."""
    calls = {"upsample": [], "fusion_block": 0, "fusion_bt": 0}

    def up(x, *a, _f=tup.fused_upsample_conv, **k):
        calls["upsample"].append(tuple(x.shape[2:]))
        return _f(x, *a, **k)

    def counted(name, f):
        def run(*a, **k):
            calls[name] += 1
            return f(*a, **k)
        return run

    monkeypatch.setattr(tb, "fused_upsample_conv", up)
    monkeypatch.setattr(tb, "fused_fusion_block",
                        counted("fusion_block", tb.fused_fusion_block))
    monkeypatch.setattr(tb, "fused_fusion_bt", counted("fusion_bt", tb.fused_fusion_bt))
    return calls


ROUTED = {(32, 64): [(1, 2), (2, 4), (4, 8), (8, 16), (16, 32)],
          (30, 38): [(4, 5), (15, 19)]}


def test_use_pallas_fusion_constructs():
    assert tcfg.ModelConfig(use_pallas_fusion=True).use_pallas_fusion is True
    assert tcfg.ModelConfig().use_pallas_fusion is False  # off by default, as in JAX
    assert jcfg.ModelConfig().use_pallas_fusion is False


@pytest.mark.parametrize("hw", [(32, 64), (30, 38)])
@pytest.mark.parametrize("channels", [3, 1], ids=["rtod", "dtod"])
def test_fusion_nets_fp32_match_flax(channels, hw, monkeypatch):
    """Both nets with use_pallas_fusion on against flax ``apply`` with
    the same flag (on the CPU flax takes its XLA route: the same
    function); the upsample wrapper takes exactly the exact-2x UpBlocks,
    the fusion-block wrapper all five FusionBlocks."""
    calls = _count_calls(monkeypatch)
    jnet, tnet = (JRtoD, RtoDNet) if channels == 3 else (JDtoD, DtoDNet)
    jc, tc = _cfgs(hw, use_pallas_fusion=True)
    x = np.random.default_rng(18).uniform(0, 1, size=(2, *hw, channels)).astype(np.float32)
    p = _net_params(hw, channels)
    want = jax.jit(lambda p, x: jnet(cfg=jc).apply({"params": p}, x))(p, x)
    with torch.inference_mode():
        got = _port(tnet(tc), p)(torch.from_numpy(x))
    assert calls == {"upsample": ROUTED[hw], "fusion_block": 5, "fusion_bt": 0}
    assert got["depth"].shape == (2, *hw, 1)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-4, atol=1e-3)
    for key in ("dec_feats", "skips"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(32, 64), (30, 38)])
def test_fusion_net_bf16_within_stated_bound(hw):
    """bf16 depth within 1% of max_depth of flax's bf16 run, as
    tests/test_torch_models.py holds the unfused route."""
    jc, tc = _cfgs(hw, "bfloat16", use_pallas_fusion=True)
    x = np.random.default_rng(19).uniform(0, 1, size=(2, *hw, 3)).astype(np.float32)
    p = _net_params(hw, 3)
    want = jax.jit(lambda p, x: JRtoD(cfg=jc).apply({"params": p}, x))(p, x)
    with torch.inference_mode():
        got = _port(RtoDNet(tc), p)(torch.from_numpy(x))
    assert got["depth"].dtype == torch.float32 and got["latent"].dtype == torch.bfloat16
    err = np.abs(got["depth"].numpy() - np.asarray(want["depth"])).max()
    assert err <= 0.01 * jc.max_depth, err


@pytest.mark.parametrize("hw", [(32, 64), (30, 38)])
def test_fusion_flag_on_matches_flag_off(hw, monkeypatch):
    """Flag on against flag off in the port, same weights: the same depth
    and the same gradients, through the two wrappers."""
    calls = _count_calls(monkeypatch)
    params = _net_params(hw, 3)
    x = torch.from_numpy(np.random.default_rng(20).uniform(
        0, 1, size=(2, *hw, 3)).astype(np.float32))
    res = []
    for fl in ({}, {"use_pallas_fusion": True}):
        _, tc = _cfgs(hw, **fl)
        net = _port(RtoDNet(tc), params)
        depth = net(x)["depth"]
        depth.square().mean().backward()
        res.append((depth.detach(), {k: p.grad for k, p in net.named_parameters()}))
        if not fl:
            assert calls == {"upsample": [], "fusion_block": 0, "fusion_bt": 0}
    assert calls == {"upsample": ROUTED[hw], "fusion_block": 5, "fusion_bt": 0}
    np.testing.assert_allclose(res[1][0].numpy(), res[0][0].numpy(), rtol=1e-4, atol=1e-3)
    for k, g in res[0][1].items():
        scale = g.abs().max().item()
        np.testing.assert_allclose(res[1][1][k].numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=k)


def test_fusion_bt_takes_precedence_over_fusion(monkeypatch):
    """With both flags the FusionBlocks go to fused_fusion_bt, as in the
    JAX package; the up-convs still go to the upsample kernel."""
    calls = _count_calls(monkeypatch)
    _, tc = _cfgs((32, 64), use_pallas_fusion=True, use_pallas_fusion_bt=True)
    net = _port(RtoDNet(tc), _net_params((32, 64), 3))
    with torch.inference_mode():
        assert torch.isfinite(net(torch.rand(1, 32, 64, 3))["depth"]).all()
    assert calls == {"upsample": ROUTED[32, 64], "fusion_block": 0, "fusion_bt": 5}


def test_use_pallas_off_turns_the_fusion_routes_off(monkeypatch):
    calls = _count_calls(monkeypatch)
    _, tc = _cfgs((32, 64), use_pallas=False, use_pallas_fusion=True,
                  use_pallas_fusion_bt=True)
    net = _port(RtoDNet(tc), _net_params((32, 64), 3))
    with torch.inference_mode():
        assert torch.isfinite(net(torch.rand(1, 32, 64, 3))["depth"]).all()
    assert calls == {"upsample": [], "fusion_block": 0, "fusion_bt": 0}


def test_fusion_flag_adds_no_parameter():
    """A state_dict from ``params_to_torch`` still loads strict=True."""
    _, tc = _cfgs((32, 64), use_pallas_fusion=True)
    theirs = params_to_torch(_net_params((32, 64), 3))
    sd = {k: torch.from_numpy(v.copy()) for k, v in theirs.items()}
    net = RtoDNet(tc)
    net.load_state_dict(sd, strict=True)
    _, plain = _cfgs((32, 64))
    assert list(net.state_dict()) == list(RtoDNet(plain).state_dict())
