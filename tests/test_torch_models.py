"""Models, config and weight import of the PyTorch port against the JAX
package.

Each block and the whole RtoDNet / DtoDNet run under flax ``apply`` and
in the port on the same numpy inputs, with the flax weights carried
over by ``params_from_flax``.  On the CPU the JAX package takes its XLA
GroupNorm path (the analytic form) and the port its plain version.
Two image sizes: 32x64 (every decoder step an exact 2x: the composed
branch) and 30x38 (a ladder that is not: the resize branch, plus the
asymmetric stride-2 SAME padding of odd sizes).

Tolerances: fp32 depth rtol 1e-4 / atol 1e-3 m (tests/test_serving.py's
bound for two compilations of the same net); bf16 depth within 1% of
max_depth (0.8 m at 80 m).  The gap measured at 30x38 is 0.41 m, at
32x64 2e-5 m: it comes from the bf16 bilinear resize of the resize
branch, which rounds at other places in the two frameworks (both lie
within one bf16 ulp of the fp32 resize) and the random net amplifies.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu.checkpoint import params_to_torch
from gdn_tpu.models import blocks as jb
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import init_params, load_pth, params_from_flax
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.models import blocks as tb

SMALL = dict(enc_channels=(8, 16), dec_channels=(16, 8), use_pallas_gn=True)


def _cfgs(hw, dtype="float32"):
    kw = dict(SMALL, image_size=hw, dtype=dtype)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _t(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _np(t):
    return t.permute(0, 2, 3, 1).float().detach().numpy()


def _flax(module, *arrays, call=None):
    """Jitted flax init + apply on numpy arrays -> (params, output);
    ``call(m, *arrays)`` gives non-array arguments."""
    call = call or (lambda m, *a: m(*a))
    init = jax.jit(lambda *a: module.init(jax.random.PRNGKey(0), *a,
                                          method=call))
    params = jax.tree_util.tree_map(np.asarray, init(*arrays)["params"])
    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=call))(
        params, *arrays)
    return params, out


@functools.lru_cache(maxsize=None)
def _net_params(hw, channels):
    """Flax weights of a small RtoDNet (3 channels) or DtoDNet (1),
    shared by the tests (they do not depend on the compute dtype)."""
    jc, _ = _cfgs(hw)
    net = (JRtoD if channels == 3 else JDtoD)(cfg=jc)
    x = np.zeros((1, *hw, channels), np.float32)
    init = jax.jit(lambda x: net.init(jax.random.PRNGKey(0), x))
    return jax.tree_util.tree_map(np.asarray, init(x)["params"])


def _port(module, params):
    module.load_state_dict(params_from_flax(params), strict=True)
    return module


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("name", [
    "ModelConfig", "LossConfig", "DataConfig", "TrainConfig", "EvalConfig",
    "MeshConfig", "Config",
])
def test_config_fields_match_jax(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [dict(f.metadata) for f in tf] == [dict(f.metadata) for f in jf]
    if name != "Config":
        assert getattr(tcfg, name)().__dict__ == getattr(jcfg, name)().__dict__


def test_preset_configs_match_jax():
    for fn in ("kitti_config", "nyu_config"):
        t = getattr(tcfg, fn)(**{"model.use_pallas_gn": True})
        j = getattr(jcfg, fn)(**{"model.use_pallas_gn": True})
        for part in ("model", "eval", "data"):
            assert getattr(t, part).__dict__ == getattr(j, part).__dict__
    assert tcfg.ModelConfig().compute_dtype == torch.bfloat16
    assert tcfg.ModelConfig(dtype="float32").compute_dtype == torch.float32


@pytest.mark.parametrize("field,value", [
    ("upsample", "deconv"), ("fusion", "add"), ("norm", "none"),
    ("quant", "int8"), ("multiscale_heads", True), ("activation", "relu"),
    ("use_pallas_convgn", True), ("use_pallas_convgn_bt", True),
    ("use_pallas_convgn_s2", True), ("use_pallas_fusion", True),
    ("use_pallas_fusion_bt", True),
])
def test_unported_values_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcfg.ModelConfig(**{field: value})


# ----------------------------------------------------------------- weights

def test_params_from_flax_equals_params_to_torch(tmp_path):
    jc, tc = _cfgs((32, 64))
    params = _net_params((32, 64), 3)
    ours = params_from_flax(params)
    theirs = params_to_torch(params)
    assert list(ours) == list(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    RtoDNet(tc).load_state_dict(ours, strict=True)
    # the .pth scripts/export_torch.py writes loads the same way
    path = str(tmp_path / "g.pth")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in theirs.items()}, path)
    sd = load_pth(path)
    RtoDNet(tc).load_state_dict(sd, strict=True)
    assert all(torch.equal(sd[k], ours[k]) for k in ours)


def test_init_params_is_seeded_and_complete():
    _, tc = _cfgs((32, 64))
    a = init_params(tc, torch.Generator().manual_seed(0))
    b = init_params(tc, torch.Generator().manual_seed(0))
    assert list(a) == list(RtoDNet(tc).state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    k = a["encoder.down1.ConvBlock_1.Conv_0.kernel"]  # fan_in 9*16
    assert abs(k.std().item() - (1 / 144) ** 0.5) < 0.02
    assert torch.equal(a["decoder.up0.fuse.scale"], torch.ones(16))
    d = init_params(tc, torch.Generator().manual_seed(0), in_channels=1)
    DtoDNet(tc).load_state_dict(d, strict=True)


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("kernel,stride,hw", [
    (7, 1, (10, 12)), (3, 2, (10, 12)), (3, 2, (9, 13)), (3, 1, (9, 13)),
])
def test_conv_block_matches_flax(kernel, stride, hw):
    jc, tc = _cfgs((32, 64))
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    p, want = _flax(jb.ConvBlock(8, kernel=kernel, stride=stride, cfg=jc), x)
    got = _port(tb.ConvBlock(5, 8, kernel, stride, tc), p)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_down_block_matches_flax():
    jc, tc = _cfgs((32, 64))
    x = np.random.default_rng(1).normal(size=(2, 15, 19, 4)).astype(np.float32)
    p, want = _flax(jb.DownBlock(8, cfg=jc), x)
    got = _port(tb.DownBlock(4, 8, tc), p)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_fusion_block_matches_flax():
    jc, tc = _cfgs((32, 64))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 12, 8)).astype(np.float32)
    lat = rng.normal(size=(2, 8, 12, 4)).astype(np.float32)
    p, want = _flax(jb.FusionBlock(8, cfg=jc), x, lat)
    got = _port(tb.FusionBlock(8, 4, 8, tc), p)(_t(x), _t(lat))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw,target", [
    ((4, 6), (8, 12)),  # exact 2x: composed transposed conv
    ((4, 6), (7, 11)),  # not 2x: resize then conv
    ((1, 3), (2, 6)),  # 2x but H < 2: resize then conv
])
def test_up_block_matches_flax(hw, target):
    jc, tc = _cfgs((32, 64))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, *hw, 16)).astype(np.float32)
    lat = rng.normal(size=(2, *target, 8)).astype(np.float32)
    p, want = _flax(jb.UpBlock(8, cfg=jc), x, lat,
                    call=lambda m, x, lat: m(x, target, lat))
    got = _port(tb.UpBlock(16, 8, 8, tc), p)(_t(x), target, _t(lat))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_depth_head_matches_flax():
    jc, tc = _cfgs((32, 64), "bfloat16")
    x = np.random.default_rng(4).normal(size=(2, 6, 10, 8)).astype(np.float32)
    p, want = _flax(jb.DepthHead(cfg=jc), x)
    got = _port(tb.DepthHead(8, tc), p)(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-3)


# -------------------------------------------------------------- whole nets

def _whole(hw, dtype, jnet, tnet, channels, seed):
    jc, tc = _cfgs(hw, dtype)
    x = np.random.default_rng(seed).uniform(
        0, 1, size=(2, *hw, channels)).astype(np.float32)
    p = _net_params(hw, channels)
    want = jax.jit(lambda p, x: jnet(cfg=jc).apply({"params": p}, x))(p, x)
    with torch.inference_mode():
        got = _port(tnet(tc), p)(torch.from_numpy(x))
    return jc, want, got


@pytest.mark.parametrize("hw", [(32, 64), (30, 38)])
def test_rtod_fp32_matches_flax(hw):
    jc, want, got = _whole(hw, "float32", JRtoD, RtoDNet, 3, 5)
    assert got["depth"].shape == (2, *hw, 1)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-4, atol=1e-3)
    for key in ("dec_feats", "skips"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["latent"].numpy(), np.asarray(want["latent"]),
                               rtol=1e-4, atol=1e-4)
    assert got["depth_scales"] == [] and want["depth_scales"] == []


@pytest.mark.parametrize("hw", [(32, 64), (30, 38)])
def test_rtod_bf16_within_stated_bound(hw):
    jc, want, got = _whole(hw, "bfloat16", JRtoD, RtoDNet, 3, 6)
    assert got["depth"].dtype == torch.float32
    assert got["latent"].dtype == torch.bfloat16
    err = np.abs(got["depth"].numpy() - np.asarray(want["depth"])).max()
    assert err <= 0.01 * jc.max_depth, err


def test_dtod_fp32_matches_flax():
    _, want, got = _whole((30, 38), "float32", JDtoD, DtoDNet, 1, 7)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-4, atol=1e-3)
