"""Fused guidance of the PyTorch port against the JAX package: the paired
encoder ladder (``train/fused_encoders.py``), the shared decoder pass
with its hand-written backward (``train/guided_decoder.py``) and the
fused stage-2 loss and step (``train/steps.py::_stage2_loss_fused``).

Both packages run on the CPU in fp32, on the same seeded numpy batch
(``synthetic_batch`` plus continuous noise on the depth, so that no L1
term sits on a tie) and the same weights: the port's ``init_params``
draws carried into flax trees by ``gdn_tpu.checkpoint.params_from_torch``
(templates from ``jax.eval_shape``), the G-net holding the D-net's
decoder as after the transfer.  Tolerances: the paired ladder rtol 1e-5
/ atol 1e-5 (the JAX suite holds its ladder to JAX's two at atol 1e-6;
across frameworks and summation orders the port's sits up to 5e-6 off);
loss terms rtol 1e-5; gradients at the port's training-parity bound,
rtol 1e-3 with an atol of 1e-4 of each tensor's largest magnitude
(``tests/test_torch_variants.py``).  The JAX losses and gradients run
under ``jax.jit``, once a configuration (cached for the module).
"""

import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu.checkpoint import params_from_torch
from gdn_tpu.data.synthetic import synthetic_batch as j_batch
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.models.encoder import Encoder as JEncoder
from gdn_tpu.train import fused_encoders as jfe
from gdn_tpu.train import steps as jsteps
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import init_params, params_from_flax
from gdn_tpu_torch.data.synthetic import SyntheticDataset
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train import state as tstate
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.train.fused_encoders import paired_encoders
from gdn_tpu_torch.train.guided_decoder import shared_guided_decoder
from gdn_tpu_torch.train.loop import train_stage1, train_stage2
from gdn_tpu_torch.utils.logging import MetricLogger

HW = (32, 64)
B = 3
SMALL = dict(enc_channels=(8, 16), dec_channels=(16, 8), dtype="float32",
             use_pallas_gn=True)
# name -> (TrainConfig fields, ModelConfig fields)
CASES = {
    "autodiff": (dict(fused_guidance=True), {}),
    "vjp": (dict(fused_guidance=True, fused_guidance_vjp=True), {}),
    "encoders": (dict(fused_guidance=True, fused_encoders=True), {}),
    "vjp_encoders_multiscale": (dict(fused_guidance=True, fused_guidance_vjp=True,
                                     fused_encoders=True), dict(multiscale_heads=True)),
}


def _cfgs(train=None, model=None, hw=HW):
    m = dict(SMALL, image_size=hw, **(model or {}))
    t = dict(ckpt_dir="", **(train or {}))
    return (jcfg.Config(model=jcfg.ModelConfig(**m), train=jcfg.TrainConfig(**t)),
            tcfg.Config(model=tcfg.ModelConfig(**m), train=tcfg.TrainConfig(**t)))


@functools.lru_cache(maxsize=None)
def _params(multiscale=False, hw=HW):
    """(D-net, G-net) weights as flax trees of numpy arrays: the port's
    draws (seeds 1, 2), the G-net with the D-net's decoder."""
    jc, tc = _cfgs(model=dict(multiscale_heads=multiscale), hw=hw)
    out = []
    for cls, ch, seed in ((JDtoD, 1, 1), (JRtoD, 3, 2)):
        x = jax.ShapeDtypeStruct((1, *hw, ch), jnp.float32)
        tmpl = jax.eval_shape(lambda x: cls(cfg=jc.model).init(jax.random.PRNGKey(0), x),
                              x)["params"]
        sd = init_params(tc.model, torch.Generator().manual_seed(seed), in_channels=ch)
        out.append(jax.tree_util.tree_map(np.asarray, params_from_torch(tmpl, sd)))
    d, g = out
    return d, {**g, "decoder": d["decoder"]}


@functools.lru_cache(maxsize=None)
def _batch(seed=3, hw=HW):
    b = {k: np.asarray(v) for k, v in j_batch(jax.random.PRNGKey(seed), B, *hw,
                                              80.0).items()}
    noise = np.random.default_rng(seed).uniform(0.0, 0.05, b["depth"].shape)
    b["depth"] = (b["depth"] + noise).astype(np.float32)
    return b


def _tb(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _nets(tc, multiscale=False):
    d_p, g_p = _params(multiscale, tuple(tc.model.image_size))
    d_net, g_net = DtoDNet(tc.model), RtoDNet(tc.model)
    d_net.load_state_dict(params_from_flax(d_p), strict=True)
    g_net.load_state_dict(params_from_flax(g_p), strict=True)
    d_net.requires_grad_(False)
    g_net.decoder.requires_grad_(False)
    return d_net, g_net


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _trainable(grads):
    return {k: v for k, v in grads.items() if not k.startswith("decoder.")}


def _grads_close(got, want, what):
    assert set(got) == set(want), what
    for k, g in want.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[k], g, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f"{what} {k}")


def _terms_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=f"{what} {k}")


@functools.lru_cache(maxsize=None)
def _jax_loss(case):
    """(terms, trainable grads) of the JAX package's loss for a case:
    ``_stage2_loss_fused`` or, for ``case="two_net"``, the two-net
    ``_stage2_loss``."""
    if case == "two_net":
        jc, _ = _cfgs()
        jd, jg = JDtoD(cfg=jc.model), JRtoD(cfg=jc.model)
        fn = lambda p, d, b: jsteps._stage2_loss(p, d, jg.apply, jd.apply, b, jc)  # noqa: E731
        multiscale = False
    else:
        train, model = CASES[case]
        jc, _ = _cfgs(train, model)
        fn = lambda p, d, b: jsteps._stage2_loss_fused(p, d, b, jc)  # noqa: E731
        multiscale = bool(model)
    d_p, g_p = _params(multiscale)
    (_, terms), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(g_p, d_p, _batch())
    return ({k: float(v) for k, v in terms.items()}, _trainable(_flat(grads)))


@functools.lru_cache(maxsize=None)
def _port_loss(case):
    train, model = CASES[case]
    _, tc = _cfgs(train, model)
    d_net, g_net = _nets(tc, bool(model))
    terms = tsteps._stage2_loss_fn(tc)(g_net, d_net, _tb(_batch()), tc)
    terms["total"].backward()
    assert all(p.grad is None for p in g_net.decoder.parameters())
    assert all(p.grad is None for p in d_net.parameters())
    return ({k: float(v.detach()) for k, v in terms.items()},
            {k: p.grad.numpy() for k, p in g_net.named_parameters() if p.requires_grad})


# ------------------------------------------------------------ paired ladder

def _close(got, want, rtol, atol):
    """(latent, latent, skips, skips) of the port (NCHW tensors) against
    the same four (NHWC arrays or NCHW tensors)."""
    def nhwc(t):
        return t.permute(0, 2, 3, 1).detach().numpy() if torch.is_tensor(t) else np.asarray(t)

    for name, g, w in zip(("d_latent", "g_latent"), got[:2], want[:2]):
        np.testing.assert_allclose(nhwc(g), nhwc(w), rtol=rtol, atol=atol, err_msg=name)
    for name, gs, ws in zip(("d_skips", "g_skips"), got[2:], want[2:]):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(nhwc(g), nhwc(w), rtol=rtol, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("hw", [HW, (30, 38)])
def test_paired_encoders_match_jax(hw):
    """The port's paired ladder against the JAX paired ladder, against
    two JAX ``Encoder`` calls and against the port's own two ``Encoder``
    calls (odd sizes: XLA's asymmetric stride-2 pads inside the grouped
    convs), rtol 1e-5 / atol 1e-5: the grouped conv and the 2G-group
    statistics sum in other orders than two ungrouped ladders, which
    moves outputs of magnitude ~1 by up to 5e-6 after 11 layers."""
    jc, tc = _cfgs(hw=hw)
    d_p, g_p = _params(False, hw)
    b = _batch(5, hw)
    depth_n = b["depth"] / jc.model.max_depth
    rgb_c = b["rgb"] * 2.0 - 1.0
    encode = jax.jit(lambda p, x: JEncoder(cfg=jc.model).apply({"params": p}, x))
    (dl, ds), (gl, gs) = encode(d_p["encoder"], depth_n), encode(g_p["encoder"], rgb_c)
    paired = jax.jit(lambda *a: jfe.paired_encoders(*a, jc.model))(
        depth_n, rgb_c, d_p["encoder"], g_p["encoder"])
    d_net, g_net = _nets(tc)
    depth_t = torch.from_numpy(depth_n).permute(0, 3, 1, 2)
    rgb_t = torch.from_numpy(rgb_c).permute(0, 3, 1, 2)
    got = paired_encoders(depth_t, rgb_t, d_net.encoder, g_net.encoder, tc.model)
    assert len(got[2]) == len(tc.model.enc_channels)
    _close(got, paired, 1e-5, 1e-5)
    _close(got, (dl, gl, ds, gs), 1e-5, 1e-5)
    with torch.no_grad():
        (tdl, tds), (tgl, tgs) = d_net.encoder(depth_t), g_net.encoder(rgb_t)
    _close(got, (tdl, tgl, tds, tgs), 1e-5, 1e-5)


def test_paired_encoders_send_gradients_to_the_g_weights_only():
    _, tc = _cfgs()
    d_net, g_net = _nets(tc)
    d_net.requires_grad_(True)  # even a D-net that would take gradients gets none
    b = _tb(_batch())
    d_lat, g_lat, d_sk, g_sk = paired_encoders(
        b["depth"].permute(0, 3, 1, 2) / 80.0, b["rgb"].permute(0, 3, 1, 2) * 2 - 1,
        d_net.encoder, g_net.encoder, tc.model)
    assert not d_lat.requires_grad and not any(s.requires_grad for s in d_sk)
    (g_lat.square().sum() + sum(s.sum() for s in g_sk)).backward()
    assert all(p.grad is None for p in d_net.parameters())
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in g_net.encoder.parameters())


# ------------------------------------------------------- shared decoder pass

def test_shared_guided_decoder_pulls_the_g_half_through_a_b_wide_recompute():
    """Forward 2B wide, no graph kept; backward one B-wide decoder run;
    gradients of the G inputs equal autograd's through the 2B-wide pass;
    the D inputs and the frozen decoder get none."""
    _, tc = _cfgs(model=dict(multiscale_heads=True))
    d_net, g_net = _nets(tc, multiscale=True)
    with torch.no_grad():
        d_lat, d_sk = d_net.encoder(_tb(_batch())["depth"].permute(0, 3, 1, 2) / 80.0)
    gen = torch.Generator().manual_seed(0)
    g_lat = torch.randn(d_lat.shape, generator=gen).requires_grad_()
    g_sk = [torch.randn(s.shape, generator=gen).requires_grad_() for s in d_sk]
    widths = []
    g_net.decoder.register_forward_pre_hook(lambda m, a: widths.append(a[0].shape[0]))
    depth, feats, scales = shared_guided_decoder(g_net.decoder, d_lat, g_lat, d_sk, g_sk)
    assert widths == [2 * B] and depth.shape[0] == 2 * B
    assert len(scales) == len(tc.model.dec_channels) and scales[-1] is depth
    ref_depth, ref_feats, ref_scales = g_net.decoder(
        torch.cat([d_lat, g_lat]), [torch.cat([d, g]) for d, g in zip(d_sk, g_sk)])
    for got, want in zip((depth, *feats, *scales), (ref_depth, *ref_feats, *ref_scales)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def loss(depth, feats, scales):
        return (depth[B:].square().mean() + sum(f[B:].abs().mean() for f in feats)
                + sum(s[B:].mean() for s in scales[:-1]))

    grads = torch.autograd.grad(loss(depth, feats, scales), [g_lat, *g_sk])
    assert widths == [2 * B, 2 * B, B]
    want = torch.autograd.grad(loss(ref_depth, ref_feats, ref_scales), [g_lat, *g_sk])
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    assert all(p.grad is None for p in g_net.decoder.parameters())


def test_shared_guided_decoder_refuses_a_decoder_that_trains():
    _, tc = _cfgs()
    _, g_net = _nets(tc)
    g_net.decoder.requires_grad_(True)
    x = torch.zeros(1, 16, 8, 16)
    with pytest.raises(ValueError, match="frozen decoder"):
        shared_guided_decoder(g_net.decoder, x, x, [], [])


# --------------------------------------------------------- the fused loss

@pytest.mark.parametrize("case", list(CASES))
def test_fused_loss_matches_jax_fused_loss(case):
    """Terms and the G-net's gradients of ``_stage2_loss_fused`` against
    the JAX package's, for the autodiff backward, the hand-written one
    and the paired ladder (with the multi-scale heads in one case)."""
    got_t, got_g = _port_loss(case)
    want_t, want_g = _jax_loss(case)
    if CASES[case][1]:
        assert "scales" in got_t
    _terms_close(got_t, want_t, case)
    _grads_close(got_g, want_g, case)


@pytest.mark.parametrize("case", ["autodiff", "vjp", "encoders"])
def test_fused_loss_matches_jax_two_net_loss(case):
    """The same against the JAX two-net ``_stage2_loss``: the fused pass
    computes the two-net step's function."""
    got_t, got_g = _port_loss(case)
    want_t, want_g = _jax_loss("two_net")
    _terms_close(got_t, want_t, case)
    _grads_close(got_g, want_g, case)


@pytest.mark.parametrize("case", ["autodiff", "vjp", "encoders"])
def test_fused_step_matches_jax_two_net_step(case):
    """One ``make_stage2_step`` step of each fused configuration: its
    terms and the gradients it applies (caught before the update)
    against the JAX two-net step's loss; the update is Adam's first
    (each parameter moves by at most lr) and leaves the frozen decoder
    and the D-net as they were."""
    train, _ = CASES[case]
    lr = 1e-3
    _, tc = _cfgs(dict(train, lr=lr))
    d_net, g_net = _nets(tc)
    state = tstate.TrainState(g_net, tc.train, 10, freeze_decoder=True)
    before = {k: v.clone() for k, v in g_net.state_dict().items()}
    d_before = {k: v.clone() for k, v in d_net.state_dict().items()}
    applied = {}
    apply = state.apply_gradients

    def spy():
        applied.update({k: p.grad.clone().numpy() for k, p in g_net.named_parameters()
                        if p.requires_grad})
        apply()

    state.apply_gradients = spy
    state, terms = tsteps.make_stage2_step(tc)(state, d_net, _tb(_batch()))
    want_t, want_g = _jax_loss("two_net")
    _terms_close(terms, want_t, case)
    _grads_close(applied, want_g, case)
    for k, v in g_net.state_dict().items():
        moved = (v - before[k]).abs().max().item()
        if k.startswith("decoder."):
            assert moved == 0, k
        else:
            assert 0 < moved <= lr * (1 + 1e-3), k  # an fp32 ulp of a weight ~1
    assert all(torch.equal(v, d_before[k]) for k, v in d_net.state_dict().items())


# ----------------------------------------------------------------- refusals

@pytest.mark.parametrize("train,match", [
    (dict(fused_guidance=True, freeze_decoder=False), "requires freeze_decoder"),
    (dict(fused_encoders=True), "requires fused_guidance"),
    (dict(fused_encoders=True, freeze_decoder=False), "requires fused_guidance"),
])
def test_refusals_carry_the_jax_messages(train, match):
    """The JAX package asserts; the port raises ValueError (an assert
    would vanish under ``python -O``) with the same message."""
    jc, tc = _cfgs(train)
    with pytest.raises(AssertionError, match=match):
        jsteps.make_stage2_step(jc)
    with pytest.raises(ValueError, match=match):
        tsteps.make_stage2_step(tc)
    k = dataclasses.replace(tc, train=dataclasses.replace(tc.train, steps_per_call=2))
    with pytest.raises(ValueError, match=match):
        tsteps.make_stage2_multistep(k, 2)


def test_fused_encoders_refuse_norm_none():
    _, tc = _cfgs(dict(fused_guidance=True, fused_encoders=True), dict(norm="none"))
    with pytest.raises(ValueError, match="norm='group'"):
        tsteps.make_stage2_step(tc)


def test_fused_path_applies_no_remat():
    """As in the JAX package, ``_stage2_loss_fused`` takes no checkpoint:
    with remat on, the G encoder still runs once a step."""
    runs = []
    for train in (dict(remat=True), dict(remat=True, fused_guidance=True)):
        _, tc = _cfgs(train)
        d_net, g_net = _nets(tc)
        n = [0]
        g_net.encoder.register_forward_hook(lambda *a: n.__setitem__(0, n[0] + 1))
        tsteps._stage2_loss_fn(tc)(g_net, d_net, _tb(_batch()), tc)["total"].backward()
        runs.append(n[0])
    assert runs == [2, 1]


# --------------------------------------------------------- config and loop

def test_the_knobs_build_in_both_packages():
    kw = dict(fused_guidance=True, fused_guidance_vjp=True, fused_encoders=True,
              steps_per_call=4, remat=True, remat_policy="dots_saveable")
    assert (dataclasses.asdict(tcfg.TrainConfig(**kw))
            == dataclasses.asdict(jcfg.TrainConfig(**kw)))


def test_train_stage2_fused_through_the_loop():
    """train_stage2 with every fused-guidance knob and two steps a call:
    finite terms in the log, the frozen decoder and the D-net untouched,
    the G encoder moved."""
    _, tc = _cfgs(dict(fused_guidance=True, fused_guidance_vjp=True, fused_encoders=True,
                       steps_per_call=2, steps_per_epoch=4, log_every=2))
    tc = dataclasses.replace(tc, data=dataclasses.replace(tc.data, batch_size=2))
    stream = io.StringIO()
    data = SyntheticDataset(2, *HW, 80.0, seed=0, device="cpu")
    s1 = train_stage1(tc, data, epochs=1, logger=MetricLogger(stream=io.StringIO()),
                      device="cpu")
    d_sd = {k: v.clone() for k, v in s1.net.state_dict().items()}
    s2 = train_stage2(tc, data, d_sd, epochs=1, logger=MetricLogger(stream=stream),
                      device="cpu")
    assert s2.step == 4 and s2.updates == 4
    lines = [ln for ln in stream.getvalue().splitlines() if "step=" in ln]
    assert len(lines) == 2 and "step=2" in lines[0] and "step=4" in lines[1]
    for k, v in s2.net.decoder.state_dict().items():
        assert torch.equal(v, d_sd[f"decoder.{k}"]), k
    init = init_params(tc.model, torch.Generator().manual_seed(tc.train.seed), in_channels=3)
    assert not torch.equal(s2.net.state_dict()["encoder.stem.Conv_0.kernel"],
                           init["encoder.stem.Conv_0.kernel"])
