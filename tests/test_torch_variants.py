"""The model variants of the PyTorch port against the JAX package: the
deconv decoder (bilinear and lecun init, with and without its GroupNorm),
add fusion, ``norm="none"``, the relu / gelu / leaky_relu activations
and the multi-scale heads with their loss.

Each case runs flax and the port on the same numpy inputs from a seed,
with the flax weights carried over by ``params_from_flax``; on the CPU
the JAX package takes its XLA route and the port its plain one.
Whole nets run on the port's ``init_params`` draws carried into the
flax tree by ``gdn_tpu.checkpoint.params_from_torch`` (whose template,
from ``jax.eval_shape`` of the flax init, also holds the keys and
shapes); flax modules are applied eagerly, and the JAX step and loss
gradients under ``jax.jit``, which keeps the file's compile time down.
Tolerances, as in tests/test_torch_models.py and test_torch_train.py:
ELU one ulp (fp32 1e-6, bf16 2^-7 relative); fp32 blocks rtol 1e-4 / atol 1e-5, fp32 depth rtol 1e-4 / atol 1e-3 m,
bf16 depth within 1% of max_depth; loss terms rtol 1e-5; the terms of a
training step atol 1e-4 / rtol 1e-3 and its gradients rtol 1e-3 with an
atol of 1e-4 of each tensor's largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu import losses as jl
from gdn_tpu.checkpoint import params_from_torch
from gdn_tpu.data.synthetic import synthetic_batch as j_batch
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.models import blocks as jb
from gdn_tpu.ops import elu as jelu
from gdn_tpu.ops import quant as jq
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch import losses as tl
from gdn_tpu_torch.checkpoint import (
    init_params, params_from_flax, quant_from_flax, transfer_stage1_decoder,
)
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.models import blocks as tb
from gdn_tpu_torch.ops import quant as tq
from gdn_tpu_torch.ops.elu import elu_saveout
from gdn_tpu_torch.ops.resize import compose_bilinear_deconv_kernel, resize_bilinear
from gdn_tpu_torch.serving import BatchedPredictor, export_model, load_model
from gdn_tpu_torch.train import state as tstate
from gdn_tpu_torch.train import steps as tsteps

SMALL = dict(enc_channels=(8, 16), dec_channels=(16, 8), use_pallas_gn=True)
MAIN = dict(upsample="deconv", multiscale_heads=True)  # the slice's main path
VARIANTS = {
    "deconv_multiscale": MAIN,
    "deconv_lecun_gn": dict(upsample="deconv", deconv_init="lecun", deconv_gn=True),
    "add": dict(fusion="add"),
    "add_none": dict(fusion="add", norm="none"),
    "none": dict(norm="none"),
    "relu": dict(activation="relu"),
    "gelu": dict(activation="gelu"),
    "leaky_relu": dict(activation="leaky_relu"),
}
FUSED_ALL = dict(use_pallas_convgn_bt=True, use_pallas_convgn_s2=True,
                 use_pallas_fusion_bt=True, use_pallas_fusion=True)
ACTIVATIONS = ("elu", "relu", "gelu", "leaky_relu")


def _cfgs(hw=(32, 64), dtype="float32", **kw):
    kw = dict(SMALL, image_size=hw, dtype=dtype, **kw)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _t(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _np(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _flax(module, *arrays, call=None):
    """Eager flax init + apply on numpy arrays -> (numpy params, output)."""
    call = call or (lambda m, *a: m(*a))
    params = module.init(jax.random.PRNGKey(0), *arrays, method=call)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, module.apply({"params": params}, *arrays, method=call)


def _port(module, params):
    module.load_state_dict(params_from_flax(params), strict=True)
    return module


@functools.lru_cache(maxsize=None)
def _template(variant, hw, channels):
    """The flax parameter tree of a small RtoDNet (3 channels) or DtoDNet
    (1) of a variant, as shapes (``jax.eval_shape`` of its init)."""
    jc, _ = _cfgs(hw, **VARIANTS[variant])
    net = (JRtoD if channels == 3 else JDtoD)(cfg=jc)
    x = jax.ShapeDtypeStruct((1, *hw, channels), jnp.float32)
    return jax.eval_shape(lambda x: net.init(jax.random.PRNGKey(0), x), x)["params"]


@functools.lru_cache(maxsize=None)
def _net_params(variant, hw, channels, seed=0):
    """Weights of that net as a flax tree of numpy arrays: the port's
    ``init_params`` draw, carried by ``params_from_torch`` (strict: every
    flax leaf matched, every shape equal)."""
    _, tc = _cfgs(hw, **VARIANTS[variant])
    sd = init_params(tc, torch.Generator().manual_seed(seed), in_channels=channels)
    tree = params_from_torch(_template(variant, hw, channels), sd)
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_configs_build_equal_to_the_jax_ones(variant):
    jc, tc = _cfgs(**VARIANTS[variant])
    assert tc.__dict__ == jc.__dict__


@pytest.mark.parametrize("field,value", [
    ("norm", "batch"), ("activation", "swish"), ("upsample", "pixelshuffle"),
    ("deconv_init", "zeros"), ("fusion", "mul"),
])
def test_unknown_variant_values_raise(field, value):
    with pytest.raises(ValueError, match=f"unknown {field}"):
        tcfg.ModelConfig(**{field: value})


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("norm", ["group", "none"])
def test_conv_block_matches_flax(norm, activation, stride):
    jc, tc = _cfgs(norm=norm, activation=activation)
    x = _rand(0, 2, 9, 13, 5)
    p, want = _flax(jb.ConvBlock(8, kernel=3, stride=stride, cfg=jc), x)
    got = _port(tb.ConvBlock(5, 8, 3, stride, tc), p)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fusion,norm", [("add", "group"), ("add", "none"),
                                         ("concat", "none")])
def test_fusion_block_matches_flax(fusion, norm):
    jc, tc = _cfgs(fusion=fusion, norm=norm)
    x, lat = _rand(1, 2, 8, 12, 8), _rand(2, 2, 8, 12, 4)
    p, want = _flax(jb.FusionBlock(8, cfg=jc), x, lat)
    block = _port(tb.FusionBlock(8, 4, 8, tc), p)
    if fusion == "add":
        assert p["lateral_proj"]["kernel"].shape == (1, 1, 4, 8)
    np.testing.assert_allclose(_np(block(_t(x), _t(lat))), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def _up_case(jc, tc, hw, target, seed=3):
    x, lat = _rand(seed, 2, *hw, 16), _rand(seed + 1, 2, *target, 8)
    p, want = _flax(jb.UpBlock(8, cfg=jc), x, lat,
                    call=lambda m, x, lat: m(x, target, lat))
    got = _port(tb.UpBlock(16, 8, 8, tc), p)(_t(x), target, _t(lat))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    return p


@pytest.mark.parametrize("target", [(8, 12), (7, 11)], ids=["exact2x", "odd"])
@pytest.mark.parametrize("deconv_gn", [False, True], ids=["bare", "gn"])
@pytest.mark.parametrize("init", ["bilinear", "lecun"])
def test_deconv_up_block_matches_flax(init, deconv_gn, target):
    jc, tc = _cfgs(upsample="deconv", deconv_init=init, deconv_gn=deconv_gn)
    p = _up_case(jc, tc, (4, 6), target)
    k = 6 if init == "bilinear" else 4
    assert p["ConvTranspose_0"]["kernel"].shape == (k, k, 16, 8)
    assert ("bias" in p["ConvTranspose_0"]) == (not deconv_gn)
    assert ("deconv_gn_scale" in p) == deconv_gn


@pytest.mark.parametrize("target", [(8, 12), (7, 11)], ids=["exact2x", "odd"])
def test_resize_conv_norm_none_up_block_matches_flax(target):
    jc, tc = _cfgs(norm="none")
    p = _up_case(jc, tc, (4, 6), target)
    assert set(p["ConvBlock_0"]["Conv_0"]) == {"kernel", "bias"}


def test_deconv_shrinks_to_nyu_targets():
    """At NYU's 228x304 the skips are 15x19, 29x38, 57x76: the 2x deconv
    output is one row (and column) over, and the exact-size fallback
    resizes it down, antialiased as jax.image.resize does."""
    jc, tc = _cfgs(upsample="deconv")
    _up_case(jc, tc, (8, 10), (15, 19), seed=5)
    _up_case(jc, tc, (15, 19), (29, 38), seed=7)


# -------------------------------------------------------------- elu_saveout

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elu_saveout_matches_jax(dtype):
    x = np.concatenate([_rand(4, 64), [0.0, -0.0, 1e-3, -1e-3, -20.0]]).astype(np.float32)
    g = _rand(5, x.size)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    want, vjp = jax.vjp(jelu.elu_saveout, jx)
    (want_dx,) = vjp(jg)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = elu_saveout(tx)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tx.grad.dtype == tdt
    # one ulp: XLA's and torch's expm1 round apart
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=0)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(want_dx.astype(jnp.float32)), rtol=rtol, atol=0)
    assert tx.grad[x.size - 5] == torch.tensor(g[x.size - 5]).to(tdt)  # derivative 1 at 0


def test_elu_saveout_keeps_its_output_only_and_is_plain_without_grad():
    x = torch.randn(3, 4, 5, 6, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        y = elu_saveout(x * 1.0)
    assert len(saved) == 1 and saved[0].data_ptr() == y.data_ptr()
    with torch.no_grad():
        z = elu_saveout(x)
    assert z.grad_fn is None
    torch.testing.assert_close(z, torch.nn.functional.elu(x.detach()), rtol=0, atol=0)


def test_deconv_bilinear_init_is_resize_conv_on_interior_pixels():
    """The port's deconv branch with ConvTranspose_0 = compose(k3) and a
    zero bias computes ELU(conv3x3(resize_bilinear_2x(x))), the
    resize_conv branch's function, away from the border (the JAX
    package's tests/test_models.py holds its own branch to the same)."""
    _, tc = _cfgs(upsample="deconv")
    cin, cout, h, w = 16, 8, 8, 12
    x = _t(_rand(6, 2, h, w, cin))
    k3 = torch.from_numpy(_rand(7, cout, cin, 3, 3) * 0.1)
    block = tb.UpBlock(cin, cout, 8, tc)
    with torch.no_grad():
        block.ConvTranspose_0.kernel.copy_(compose_bilinear_deconv_kernel(k3))
        block.ConvTranspose_0.bias.zero_()
        got = block(x, (2 * h, 2 * w))
    ref = torch.nn.functional.elu(torch.nn.functional.conv2d(
        resize_bilinear(x, (2 * h, 2 * w)), k3, padding=1))
    np.testing.assert_allclose(got[..., 3:-3, 3:-3].numpy(), ref[..., 3:-3, 3:-3].numpy(),
                               rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- whole nets

def _whole(variant, hw, dtype, channels, seed):
    jc, tc = _cfgs(hw, dtype, **VARIANTS[variant])
    jnet, tnet = (JRtoD, RtoDNet) if channels == 3 else (JDtoD, DtoDNet)
    x = np.random.default_rng(seed).uniform(0, 1, (2, *hw, channels)).astype(np.float32)
    p = _net_params(variant, hw, channels)
    want = jnet(cfg=jc).apply({"params": p}, x)
    with torch.inference_mode():
        got = _port(tnet(tc), p)(torch.from_numpy(x))
    return jc, want, got


@pytest.mark.parametrize("hw", [(32, 64), (30, 38)])
@pytest.mark.parametrize("channels", [3, 1], ids=["rtod", "dtod"])
def test_deconv_multiscale_nets_fp32_match_flax(channels, hw):
    _, want, got = _whole("deconv_multiscale", hw, "float32", channels, 11)
    assert set(got) == set(want)
    assert len(got["depth_scales"]) == len(want["depth_scales"]) == 2
    assert tuple(got["depth_scales"][0].shape) == (2, hw[0] // 2 + hw[0] % 2,
                                                   -(-hw[1] // 2), 1)
    torch.testing.assert_close(got["depth_scales"][-1], got["depth"], rtol=0, atol=0)
    for g, w in zip([got["depth"], *got["depth_scales"]],
                    [want["depth"], *want["depth_scales"]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)
    for key in ("dec_feats", "skips"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["latent"].numpy(), np.asarray(want["latent"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(32, 64), (30, 38)])
def test_deconv_multiscale_rtod_bf16_within_stated_bound(hw):
    jc, want, got = _whole("deconv_multiscale", hw, "bfloat16", 3, 12)
    for g, w in zip([got["depth"], *got["depth_scales"]],
                    [want["depth"], *want["depth_scales"]]):
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 0.01 * jc.max_depth


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "deconv_multiscale"])
def test_variant_rtod_fp32_matches_flax(variant):
    _, want, got = _whole(variant, (32, 64), "float32", 3, 13)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-4, atol=1e-3)
    assert got["depth_scales"] == [] and want["depth_scales"] == []


# ----------------------------------------------------------------- weights

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flax_weights_load_strict_and_init_params_has_their_shapes(variant):
    _, tc = _cfgs(**VARIANTS[variant])
    for channels, net in ((3, RtoDNet(tc)), (1, DtoDNet(tc))):
        template = _template(variant, (32, 64), channels)
        flax_sd = params_from_flax(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, np.float32), template))
        net.load_state_dict(flax_sd, strict=True)
        ours = init_params(tc, torch.Generator().manual_seed(0), in_channels=channels)
        assert {k: v.shape for k, v in ours.items()} == {
            k: v.shape for k, v in flax_sd.items()}


def test_init_params_draws_each_variant_as_flax():
    """Bilinear deconv kernels are compose(lecun 3x3, fan-in 9 cin); a
    lecun 4x4 ConvTranspose has fan-in 16 cin; lateral_proj fan-in cin;
    biases 0 and the deconv GN scale 1."""
    _, tc = _cfgs(**MAIN)
    sd = init_params(tc, torch.Generator().manual_seed(0))
    k6 = sd["decoder.up0.ConvTranspose_0.kernel"]  # (16, 16, 6, 6)
    # the 6x6 composed taps sum to 4x the sum of the 3x3 draw, whose 9
    # taps of variance 1 / (9 cin) sum to a standard deviation of 3 / (3 * 4)
    k3_sum = k6.sum(dim=(2, 3)) / 4.0
    assert abs(k3_sum.std().item() - 0.25) < 0.04
    assert torch.equal(sd["decoder.up0.ConvTranspose_0.bias"], torch.zeros(16))
    _, tc = _cfgs(**VARIANTS["deconv_lecun_gn"])
    sd = init_params(tc, torch.Generator().manual_seed(0))
    k4 = sd["decoder.up1.ConvTranspose_0.kernel"]  # (8, 16, 4, 4)
    assert abs(k4.std().item() - (1 / (16 * 16)) ** 0.5) < 0.01
    assert torch.equal(sd["decoder.up1.deconv_gn_scale"], torch.ones(8))
    _, tc = _cfgs(fusion="add")
    sd = init_params(tc, torch.Generator().manual_seed(0))
    lp = sd["decoder.up0.fuse.lateral_proj.kernel"]  # (16, 8, 1, 1): x 16, skip 8
    assert abs(lp.std().item() - (1 / lp.shape[1]) ** 0.5) < 0.06
    assert torch.equal(sd["decoder.up0.fuse.lateral_proj.bias"], torch.zeros(16))


def test_transfer_carries_heads_and_conv_transpose_and_the_freeze_covers_them():
    _, tc = _cfgs(**MAIN)
    d_sd = init_params(tc, torch.Generator().manual_seed(1), in_channels=1)
    g_sd = init_params(tc, torch.Generator().manual_seed(2))
    moved = transfer_stage1_decoder(g_sd, d_sd)
    keys = [k for k in d_sd if k.startswith("decoder.")]
    assert any(".head0." in k for k in keys) and any("ConvTranspose_0" in k for k in keys)
    for k in keys:
        assert torch.equal(moved[k], d_sd[k]), k
    assert torch.equal(moved["encoder.stem.Conv_0.kernel"], g_sd["encoder.stem.Conv_0.kernel"])
    net = RtoDNet(tc)
    net.load_state_dict(moved, strict=True)
    state = tstate.TrainState(net, tcfg.TrainConfig(), 10, freeze_decoder=True)
    trained = {id(p) for p in state.params}
    for name, p in net.named_parameters():
        assert (id(p) in trained) == (not name.startswith("decoder.")), name
    assert not net.decoder.head0.Conv_0.kernel.requires_grad


# ------------------------------------------------------------------ losses

def _loss_inputs(hw, seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1, 80, (3, *hw, 1)).astype(np.float32)
    mask = (rng.uniform(size=(3, *hw, 1)) > 0.3).astype(np.float32)
    mask[1] = 0.0  # one image with no valid pixel
    pred = rng.uniform(1, 80, (3, *hw, 1)).astype(np.float32)
    scales = [rng.uniform(1, 80, (3, -(-hw[0] // 4), -(-hw[1] // 4), 1)).astype(np.float32),
              rng.uniform(1, 80, (3, -(-hw[0] // 2), -(-hw[1] // 2), 1)).astype(np.float32)]
    return pred, gt, mask, scales


@pytest.mark.parametrize("hw", [(30, 38), (29, 45)])
def test_multiscale_depth_loss_matches_jax(hw):
    _, gt, mask, scales = _loss_inputs(hw, 20)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda s: jl.multiscale_depth_loss(s, gt, mask)))([jnp.asarray(s) for s in scales])
    ts = [torch.from_numpy(s).requires_grad_(True) for s in scales]
    got = tl.multiscale_depth_loss(ts, torch.from_numpy(gt), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused_route"])
def test_total_loss_with_scale_preds_matches_jax(use_pallas):
    pred, gt, mask, scales = _loss_inputs((30, 38), 21)
    jcfg_l = jcfg.LossConfig(use_pallas=use_pallas)
    tcfg_l = tcfg.LossConfig(use_pallas=use_pallas)

    def jfn(p, s):
        t = jl.total_loss(p, gt, mask, jcfg_l, 80.0, scale_preds=s)
        return t["total"], t

    (_, jterms), (jdp, jds) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(pred), [jnp.asarray(s) for s in scales])
    tp = torch.from_numpy(pred).requires_grad_(True)
    ts = [torch.from_numpy(s).requires_grad_(True) for s in scales]
    terms = tl.total_loss(tp, torch.from_numpy(gt), torch.from_numpy(mask), tcfg_l, 80.0,
                          scale_preds=ts)
    terms["total"].backward()
    assert set(terms) == set(jterms) and "scales" in terms
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jdp), rtol=1e-4, atol=1e-8)
    for t, g in zip(ts, jds):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------- training steps

STEP_HW = (32, 64)


def _grads_close(got, want, what):
    for k, g in want.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[k], g, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f"{what} {k}")


def _terms_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-4, rtol=1e-3,
                                   err_msg=k)


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.mark.parametrize("variant", ["deconv_multiscale", "add_none", "none"])
def test_training_steps_match_jax(variant):
    """One stage-1 and one stage-2 step's loss: terms and gradients
    against the JAX package's step losses, from the same flax weights
    and ``synthetic_batch`` arrays (fp32)."""
    jm, tm = _cfgs(STEP_HW, **VARIANTS[variant])
    jc = jcfg.Config(model=jm, train=jcfg.TrainConfig(ckpt_dir=""))
    tc = tcfg.Config(model=tm, train=tcfg.TrainConfig(ckpt_dir=""))
    b = {k: np.asarray(v) for k, v in j_batch(jax.random.PRNGKey(3), 2, *STEP_HW,
                                              80.0).items()}
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    jd, jg = JDtoD(cfg=jm), JRtoD(cfg=jm)
    d_params = _net_params(variant, STEP_HW, 1, seed=1)
    # the G-net's decoder is the D-net's, as after the transfer
    g_params = {**_net_params(variant, STEP_HW, 3, seed=2), "decoder": d_params["decoder"]}

    # stage 1
    (_, jt), jgr = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps._stage1_loss(p, jd.apply, b, jc), has_aux=True))(d_params, b)
    d_net = _port(DtoDNet(tm), d_params)
    tt = tsteps._stage1_loss(d_net, tbatch, tc)
    tt["total"].backward()
    if variant == "deconv_multiscale":
        assert "scales" in tt
    _terms_close(tt, jt)
    _grads_close({k: p.grad.numpy() for k, p in d_net.named_parameters()}, _flat(jgr),
                 "stage 1")

    # stage 2: the decoder frozen (stop_gradient in JAX, requires_grad off here)
    (_, jt), jgr = jax.jit(jax.value_and_grad(
        lambda p, d, b: jsteps._stage2_loss(p, d, jg.apply, jd.apply, b, jc),
        has_aux=True))(g_params, d_params, b)
    d_net.requires_grad_(False)
    g_net = _port(RtoDNet(tm), g_params)
    g_net.decoder.requires_grad_(False)
    tt = tsteps._stage2_loss(g_net, d_net, tbatch, tc)
    tt["total"].backward()
    assert "latent" in tt
    _terms_close(tt, jt)
    want = {k: v for k, v in _flat(jgr).items() if not k.startswith("decoder.")}
    assert all(p.grad is None for p in g_net.decoder.parameters())
    _grads_close({k: p.grad.numpy() for k, p in g_net.named_parameters()
                  if not k.startswith("decoder.")}, want, "stage 2")


def test_remat_step_over_depth_scales_equals_the_plain_step():
    _, tm = _cfgs(STEP_HW, **MAIN)
    sd = init_params(tm, torch.Generator().manual_seed(0), in_channels=1)
    batch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
             j_batch(jax.random.PRNGKey(4), 2, *STEP_HW, 80.0).items()}
    res = []
    for remat in (False, True):
        cfg = tcfg.Config(model=tm, train=tcfg.TrainConfig(ckpt_dir="", remat=remat))
        net = DtoDNet(tm)
        net.load_state_dict(sd)
        terms = tsteps._stage1_loss(net, batch, cfg)
        terms["total"].backward()
        res.append((terms, {k: p.grad for k, p in net.named_parameters()}))
    _terms_close(res[1][0], {k: float(v) for k, v in res[0][0].items()})
    for k, g in res[0][1].items():
        torch.testing.assert_close(res[1][1][k], g, rtol=1e-5, atol=1e-7)
    assert res[0][1]["decoder.head0.Conv_0.kernel"].abs().sum() > 0


# ----------------------------------------------------------------- routing

def _spy(monkeypatch):
    """Count the calls of every kernel entry point the blocks reach."""
    calls = {}
    for name in ("group_norm_elu", "fused_conv_gn_elu", "fused_conv_gn_elu_bt",
                 "fused_conv_gn_elu_s2", "fused_fusion_bt", "fused_fusion_block",
                 "fused_upsample_conv"):
        def counted(*a, _f=getattr(tb, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(tb, name, counted)
    return calls


@pytest.mark.parametrize("variant,flags,want", [
    ("none", FUSED_ALL, {}),
    ("add_none", FUSED_ALL, {}),
    ("relu", FUSED_ALL, {}),
    ("gelu", FUSED_ALL, {}),
    ("leaky_relu", FUSED_ALL, {}),
    # the bt kernel takes the encoder refines and add fusion's ConvBlock_0
    ("add", dict(use_pallas_convgn_bt=True), {"group_norm_elu": 5,
                                              "fused_conv_gn_elu_bt": 4}),
    # deconv bypasses the upsample kernel; the fusion kernel stays
    ("deconv_multiscale", dict(use_pallas_fusion=True), {"group_norm_elu": 5,
                                                         "fused_fusion_block": 2}),
    ("deconv_multiscale", {}, {"group_norm_elu": 7}),
    ("deconv_lecun_gn", {}, {"group_norm_elu": 9}),
])
def test_routing_follows_the_jax_gates(variant, flags, want, monkeypatch):
    """GroupNorm+ELU and fused entry points by config, one G-net forward
    on the CPU: none at non-ELU and norm="none" nets with every flag on."""
    calls = _spy(monkeypatch)
    _, tc = _cfgs((32, 64), **VARIANTS[variant], **flags)
    net = _port(RtoDNet(tc), _net_params(variant, (32, 64), 3))
    with torch.inference_mode():
        depth = net(torch.rand(1, 32, 64, 3))["depth"]
    assert torch.isfinite(depth).all()
    assert calls == want


# -------------------------------------------------------------------- int8

def test_int8_with_norm_none_raises_as_the_jax_package_raises():
    msg = "quant='int8' requires norm='group'"
    jc, _ = _cfgs(norm="none")
    jc = jcfg.ModelConfig(**{**jc.__dict__, "quant": "int8"})
    with pytest.raises(ValueError, match=msg):
        JRtoD(cfg=jc).init(jax.random.PRNGKey(0), np.zeros((1, 32, 64, 3), np.float32))
    with pytest.raises(ValueError, match=msg):
        tcfg.ModelConfig(norm="none", quant="int8")


@pytest.mark.parametrize("variant", ["deconv_multiscale", "add"])
def test_int8_sites_equal_jax_calibrate_quant(variant):
    """The deconv ConvTranspose and add fusion's lateral_proj stay in
    float: the int8 sites (the "quant" keys) are JAX's."""
    jc, tc = _cfgs(quant="int8", **VARIANTS[variant])
    params = _net_params(variant, (32, 64), 3)
    rgb = np.random.default_rng(30).uniform(0, 1, (2, 32, 64, 3)).astype(np.float32)
    jscales = quant_from_flax(jq.calibrate_quant(JRtoD(cfg=jc), params, [rgb]))
    net = _port(RtoDNet(tc), params)
    tscales = tq.calibrate_quant(net, [rgb])
    assert list(tscales) == list(tq.quant_sites(net))
    assert set(tscales) == set(jscales)
    assert not any("ConvTranspose" in k or "lateral_proj" in k for k in tscales)
    for k, v in tscales.items():
        assert float(v) == pytest.approx(float(jscales[k]), rel=0.01), k


# --------------------------------------------------------------- artifacts

@pytest.mark.parametrize("variant", ["deconv_multiscale", "gelu"])
def test_variant_artifact_equals_the_predictor(variant, tmp_path):
    _, tm = _cfgs((32, 64), **VARIANTS[variant])
    cfg = tcfg.Config(model=tm)
    sd = params_from_flax(_net_params(variant, (32, 64), 3))
    path = str(tmp_path / f"{variant}.pt2")
    export_model(cfg, sd, path, batch_size=2, device="cpu")
    program = torch.export.load(path)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    gn = sum(t == torch.ops.gdn_tpu_torch.group_norm_elu.default for t in targets)
    assert gn == (7 if variant == "deconv_multiscale" else 0)
    if variant == "deconv_multiscale":  # one transposed conv a decoder scale
        assert sum(t == torch.ops.aten.conv_transpose2d.input for t in targets) == 2
    rgb = np.random.default_rng(31).uniform(0, 1, (2, 32, 64, 3)).astype(np.float32)
    want = BatchedPredictor(cfg, sd, batch_size=2, device="cpu").predict(rgb)
    got = load_model(path)(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got[..., 0], want)
