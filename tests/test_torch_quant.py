"""Int8 post-training quantization of the PyTorch port
(``gdn_tpu_torch/ops/quant.py`` and the int8 sites of
``models/blocks.py``) against ``gdn_tpu.ops.quant`` on numpy inputs from
a seed, on the CPU.

Tolerances: the int8 values and the weight and activation scales are
held exactly (the port multiplies by the reciprocal of 127 where XLA
does, and divides by the activation scale where XLA does with the scales
as program arguments); the int32 sums of ``conv2d_int8`` exactly, its
fp32 output to 1e-6 relative (one product of the sum and the scales,
taken in another order); calibration in fp32 to rtol 1e-5 with the same
site keys.  Through a small G-net the two packages' fp32 convolutions
and GroupNorms sum in other orders, so an activation that lies within
rounding of a .5 step of its scale can quantize one step apart; each
such flip moves everything downstream.  So the calibration and net
tests feed the port JAX's input at every int8 site, and hold the scales
(rtol 1e-5) and the depth (rtol 1e-5 / atol 1e-5 m, the bound of
``tests/test_quant.py`` for two programs of one int8 net) there; running
free, they count the one-step flips and hold the scales within 1% and
the depth within 1% of max_depth.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from gdn_tpu import config as jcfg
from gdn_tpu.models import RtoDNet as JRtoD
from gdn_tpu.ops import quant as jq
from gdn_tpu.train import make_eval_forward as jmake_eval_forward
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import params_from_flax, quant_from_flax
from gdn_tpu_torch.models import RtoDNet
from gdn_tpu_torch.models import blocks as tb
from gdn_tpu_torch.ops import quant as tq
from gdn_tpu_torch.train.steps import make_eval_forward, make_stage1_step, make_stage2_step

HW = (32, 64)
SMALL = dict(image_size=HW, enc_channels=(8, 16), dec_channels=(16, 8), dtype="float32",
             use_pallas_gn=True, quant="int8")


def _cfgs(**over):
    kw = dict(SMALL, **over)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _config(model, mod, dataset="synthetic", data_path=""):
    return mod.Config(model=model, data=mod.DataConfig(dataset=dataset,
                                                       data_path=data_path))


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs(quant="none")
    net = JRtoD(cfg=jc)
    x = np.zeros((1, *HW, 3), np.float32)
    init = jax.jit(lambda x: net.init(jax.random.PRNGKey(0), x))
    return jax.tree_util.tree_map(np.asarray, init(x)["params"])


def _rgb(seed, b=2):
    """Smooth RGB in [0, 1] with texture, as images are (numpy)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, HW[0]), np.linspace(0, 1, HW[1]), indexing="ij")
    base = np.stack([yy, xx, 1 - yy], -1)[None]
    noise = 0.2 * rng.standard_normal((b, *HW, 3))
    return np.clip(base * rng.uniform(0.5, 1.0, (b, 1, 1, 3)) + noise, 0, 1).astype(np.float32)


def _port_net(tc, params, scales=None):
    net = RtoDNet(tc)
    net.load_state_dict(params_from_flax(params), strict=True)
    if scales is not None:
        tq.set_quant_scales(net, scales)
    return net.eval()


# ------------------------------------------------------------ quantization

@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (7, 7, 3, 8)])
def test_weight_quantization_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 2.0, shape[-1])).astype(np.float32)
    w[..., 1] = 0.0  # an all-zero channel: the 1e-12 floor of the scale
    jw8, js = jax.jit(jq.quantize_weight_per_channel)(w)
    tw8, ts = tq.quantize_weight_per_channel(torch.from_numpy(w).permute(3, 2, 0, 1))
    assert tw8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw8.permute(2, 3, 1, 0).numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_activation_quantization_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 9, 11, 8)) * 3).astype(np.float32)
    s = np.float32(0.0371)
    j8 = jax.jit(jq.quantize_act)(x, s)
    t8 = tq.quantize_act(torch.from_numpy(x), torch.tensor(s))
    assert t8.dtype == torch.int8
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    assert int(np.abs(np.asarray(j8, np.int32)).max()) == 127  # the clip is reached
    js = jax.jit(lambda x: jq.init_act_scale(x)())(x)
    assert tq.init_act_scale(torch.from_numpy(x)).item() == float(js)


@pytest.mark.parametrize("b,cin,cout,h,w,k,stride", [
    (2, 8, 16, 16, 16, 3, 1),   # a 3x3 site
    (2, 8, 16, 15, 17, 3, 2),   # stride 2, odd sizes: XLA's asymmetric SAME pads
    (2, 3, 8, 16, 20, 7, 1),    # the 7x7 stem: K = 147 padded to 152
])
def test_conv2d_int8_matches_jax(b, cin, cout, h, w, k, stride):
    rng = np.random.default_rng(h * w + k)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    kern = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127.0)
    want = np.asarray(jax.jit(jq.conv2d_int8, static_argnums=2)(x, kern, (stride, stride), xs))

    def sums(x, kern):
        return lax.conv_general_dilated(
            jq.quantize_act(x, xs), jq.quantize_weight_per_channel(kern)[0],
            (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)

    want32 = np.asarray(jax.jit(sums)(x, kern))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tk = torch.from_numpy(kern).permute(3, 2, 0, 1)
    got32 = tq.conv2d_s32(tq.quantize_act(torch.from_numpy(x), torch.tensor(xs)),
                          tq.quantize_weight_per_channel(tk)[0], stride)
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal(got32.numpy(), want32)
    got = tq.conv2d_int8(tx, tk, stride, torch.tensor(xs))
    assert got.shape == (b, cout, -(-h // stride), -(-w // stride))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=0)


# ------------------------------------------------------------ calibration

def _jax_site_inputs(monkeypatch, run):
    """``run()`` with every int8 site's input recorded (a host callback
    in the compiled program), in call order -> (run's result, [input
    (B, H, W, C) numpy])."""
    seen = []
    conv = jq.conv2d_int8

    def record(x, w, strides, x_scale, padding="SAME"):
        jax.debug.callback(lambda v: seen.append(np.array(v, np.float32)), x,
                           ordered=True)
        return conv(x, w, strides, x_scale, padding)

    monkeypatch.setattr(jq, "conv2d_int8", record)
    out = run()
    jax.effects_barrier()
    monkeypatch.setattr(jq, "conv2d_int8", conv)
    return out, seen


def _port_site_inputs(monkeypatch, run, feed=None):
    """``run()`` with every int8 site's input recorded in call order, or,
    with ``feed`` (arrays in that order), replaced by them first -> (run's
    result, [input (B, H, W, C) numpy])."""
    seen = []
    feed = iter(feed) if feed is not None else None
    conv = tb._conv_int8

    def record(block, x, kernel, stride):
        if feed is not None:
            given = next(feed)
            assert given.shape == tuple(x.permute(0, 2, 3, 1).shape)
            x = torch.from_numpy(given).permute(0, 3, 1, 2)
        seen.append(x.permute(0, 2, 3, 1).float().numpy())
        return conv(block, x, kernel, stride)

    monkeypatch.setattr(tb, "_conv_int8", record)
    out = run()
    monkeypatch.setattr(tb, "_conv_int8", conv)
    return out, seen


@pytest.mark.parametrize("min_channels", [0, 16])
def test_calibration_matches_jax(params, min_channels, monkeypatch):
    """The same explicit batches through both calibrations.  Fed JAX's
    input at every site (so that no site sees the other package's fp32
    rounding upstream), the port's scales equal JAX's to rtol 1e-5 with
    the same keys; running free, a one-step flip upstream moves a
    site's absmax: there within 1%."""
    jc, tc = _cfgs(quant_min_channels=min_channels)
    batches = [_rgb(10), _rgb(11)]
    scales, inputs = _jax_site_inputs(
        monkeypatch, lambda: jq.calibrate_quant(JRtoD(cfg=jc), params, batches))
    want = quant_from_flax(scales)
    net = _port_net(tc, params)
    got, _ = _port_site_inputs(
        monkeypatch, lambda: tq.calibrate_quant(net, [torch.from_numpy(b) for b in batches]),
        feed=inputs)
    assert list(got) == list(tq.quant_sites(net)) and set(got) == set(want)
    if min_channels:
        assert 0 < len(got) < len(tq.quant_sites(_port_net(_cfgs()[1], params)))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5,
                                   err_msg=key)
    free = tq.calibrate_quant(_port_net(tc, params), [torch.from_numpy(b) for b in batches])
    for key in want:
        np.testing.assert_allclose(free[key].numpy(), want[key].numpy(), rtol=0.01,
                                   err_msg=key)


def test_scales_are_not_in_the_state_dict(params):
    _, tc = _cfgs()
    _, tf = _cfgs(quant="none")
    net = RtoDNet(tc)
    assert set(net.state_dict()) == set(RtoDNet(tf).state_dict())
    net.load_state_dict(params_from_flax(params), strict=True)  # params only
    # the stem, two convs a DownBlock, an up-conv and a fusion an UpBlock
    assert len(tq.quant_sites(net)) == 9
    with pytest.raises(ValueError, match="missing"):
        tq.set_quant_scales(net, {})


def test_int8_net_matches_jax(params, monkeypatch):
    """The int8 G-net against JAX's apply with the same params and scales.
    Fed JAX's input at every site, the depth to rtol 1e-5 / atol 1e-5 m
    (``tests/test_quant.py``'s bound for two programs of one int8 net).
    Running free, every site's quantized input equals JAX's but for
    one-step flips, which are counted (8 on these inputs, moving the depth
    by up to 0.064 m); the depth within 1% of max_depth."""
    jc, tc = _cfgs()
    jnet = JRtoD(cfg=jc)
    scales = jq.calibrate_quant(jnet, params, [_rgb(20)])
    rgb = _rgb(21, b=3)
    apply = jax.jit(lambda p, q, x: jnet.apply({"params": p, "quant": q}, x)["depth"])
    want, jin = _jax_site_inputs(monkeypatch, lambda: np.asarray(apply(params, scales, rgb)))
    net = _port_net(tc, params, quant_from_flax(scales))
    with torch.no_grad():
        forced, _ = _port_site_inputs(
            monkeypatch, lambda: net(torch.from_numpy(rgb))["depth"].numpy(), feed=jin)
        got, tin = _port_site_inputs(
            monkeypatch, lambda: net(torch.from_numpy(rgb))["depth"].numpy())
    np.testing.assert_allclose(forced, want, rtol=1e-5, atol=1e-5)
    flips = 0
    for (key, m), a, b in zip(tq.quant_sites(net).items(), jin, tin, strict=True):
        step = (tq.quantize_act(torch.from_numpy(a), m.x_scale).int()
                - tq.quantize_act(torch.from_numpy(b), m.x_scale).int()).abs()
        assert int(step.max()) <= 1, key
        flips += int(step.sum())
    d = np.abs(got - want)
    print(f"one-step flips {flips}; depth max|d| {d.max():.3g} m")
    assert d.max() <= 0.01 * tc.max_depth


def test_zero_site_calibration_raises(params):
    jc, tc = _cfgs(quant_min_channels=100000)
    with pytest.raises(ValueError, match="ZERO conv sites"):
        jq.calibrate_quant(JRtoD(cfg=jc), params, [_rgb(0)])
    with pytest.raises(ValueError, match="ZERO conv sites"):
        tq.calibrate_quant(_port_net(tc, params), [torch.from_numpy(_rgb(0))])
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate_quant(_port_net(_cfgs()[1], params), [])


def test_int8_training_is_refused():
    _, tc = _cfgs()
    cfg = _config(tc, tcfg)
    for make in (make_stage1_step, make_stage2_step):
        with pytest.raises(ValueError, match="inference-only"):
            make(cfg)


def test_int8_eval_forward_matches_jax(params):
    jc, tc = _cfgs()
    scales = jq.calibrate_quant(JRtoD(cfg=jc), params, [_rgb(30)])
    rgb = _rgb(31)
    want = jmake_eval_forward(_config(jc, jcfg), JRtoD(cfg=jc), flip_tta=True,
                              quant_scales=scales)(params, rgb)
    tcfg_ = _config(tc, tcfg)
    net = _port_net(tc, params)
    with pytest.raises(ValueError, match="calibrated activation scales"):
        make_eval_forward(tcfg_, net)
    fwd = make_eval_forward(tcfg_, net, flip_tta=True, quant_scales=quant_from_flax(scales))
    got = fwd(torch.from_numpy(rgb))
    assert got.shape == (2, *HW, 1)
    with torch.no_grad():  # the scales were set; TTA as one forward of 2B images
        both = net(torch.from_numpy(np.concatenate([rgb, rgb[:, :, ::-1]])))["depth"]
    np.testing.assert_array_equal(got.numpy(), (0.5 * (both[:2] + both[2:].flip(2))).numpy())
    # one-step flips aside (test_int8_net_matches_jax), JAX's eval forward
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 0.01 * tc.max_depth


def test_quant_config_values():
    assert tcfg.ModelConfig(quant="int8", quant_min_channels=64).quant == "int8"
    with pytest.raises(ValueError, match="unknown quant"):
        tcfg.ModelConfig(quant="int4")


# ------------------------------------------------------------ calibration sources

def test_resolve_calibration_sources(tmp_path):
    """A directory of images > the train split > synthetic scenes, as the
    JAX package resolves them; the directory's images resized alike."""
    _, tc = _cfgs()
    jc, _ = _cfgs()
    tconf, jconf = _config(tc, tcfg), _config(jc, jcfg)
    batches, label = tq.resolve_calibration_batches(tconf, prefer_train_split=True)
    assert label == "synthetic" and len(batches) == 8
    assert tuple(batches[0].shape) == (8, *HW, 3) and batches[0].device.type == "cpu"
    again = list(tq.synthetic_calibration_batches(tconf, 2, 8))
    assert all(torch.equal(a, b) for a, b in zip(batches, again))  # a CPU generator

    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.uniform(0, 255, (20, 40, 3)).astype(np.uint8)).save(
            tmp_path / f"img{i}.png")
    got, label = tq.resolve_calibration_batches(tconf, calib_dir=str(tmp_path),
                                                prefer_train_split=True)
    want, jlabel = jq.resolve_calibration_batches(jconf, calib_dir=str(tmp_path))
    assert label == jlabel == f"dir:{tmp_path}"
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-6)


def test_train_split_calibration_batches(tmp_path):
    """The train split's first batches, wire-decoded, as the JAX package's
    (4 pairs: smaller than a batch of 8, so image by image)."""
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "scene")
    lines = []
    for i in range(4):
        Image.fromarray(rng.uniform(0, 255, (*HW, 3)).astype(np.uint8)).save(
            tmp_path / "scene" / f"{i}.png")
        Image.fromarray((rng.uniform(0, 80, HW) * 256).astype(np.uint16)).save(
            tmp_path / "scene" / f"{i}_d.png")
        lines.append(f"scene/{i}.png scene/{i}_d.png")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    jc, tc = _cfgs()
    want = jq.train_split_calibration_batches(
        _config(jc, jcfg, "kitti", str(tmp_path)), n_batches=2)
    tconf = _config(tc, tcfg, "kitti", str(tmp_path))
    got = tq.train_split_calibration_batches(tconf, n_batches=2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (1, *HW, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batches, label = tq.resolve_calibration_batches(tconf, prefer_train_split=True)
    assert label == "train-split" and len(batches) == 4
    # without the preference the synthetic scenes, as the JAX package
    assert tq.resolve_calibration_batches(tconf)[1] == "synthetic"


def test_quantized_model_and_scales(params):
    _, tc = _cfgs()
    conf = _config(tc, tcfg)
    batches = [torch.from_numpy(_rgb(40))]
    net, scales = tq.quantized_model_and_scales(conf, params_from_flax(params),
                                                calib_batches=batches, device="cpu")
    assert set(scales) == set(tq.quant_sites(net))
    assert all(net.get_submodule(k[:-len(".x_scale")]).x_scale.item() == v.item()
               for k, v in scales.items())
    with pytest.raises(ValueError, match="quant='int8'"):
        tq.quantized_model_and_scales(_config(dataclasses.replace(tc, quant="none"), tcfg),
                                      params_from_flax(params), calib_batches=batches,
                                      device="cpu")
