"""Losses, SSIM, the fused loss and the GroupNorm+ELU backward of the
PyTorch port against the JAX package, on the same numpy inputs.

On the CPU the port's fused-loss wrapper runs its plain version (sums
through ops/ssim.py, gradient by autograd); it is held to the JAX
package's Pallas kernel in interpret mode at the JAX suite's tolerances
(tests/test_kernels.py: values rel 1e-5, gradients rtol 2e-4 / atol
1e-7).  ``total_loss`` takes the fused route (use_pallas) or the plain
one on any device; the JAX package on the CPU always takes its jnp
route, which its own suite holds to its kernel, so both port routes are
held to JAX's jnp route.  GroupNorm+ELU: the analytic autograd Function
against ``jax.vjp`` of ``group_norm_elu_analytic`` (fp32 rtol 1e-4 /
atol 1e-5; bf16 rtol and atol 0.05, the bound of
tests/test_torch_groupnorm.py).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu import losses as jl
from gdn_tpu.kernels.fused_loss import fused_loss_terms as j_fused
from gdn_tpu.ops import groupnorm as jgn
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch import losses as tl
from gdn_tpu_torch.kernels import fused_loss as tfl
from gdn_tpu_torch.kernels.groupnorm import group_norm_elu
from gdn_tpu_torch.ops import groupnorm as tgn
from gdn_tpu_torch.ops import ssim as tssim

# gdn_tpu.ops re-exports the function ssim under the module's name
jssim = importlib.import_module("gdn_tpu.ops.ssim")
VAL = dict(rel=1e-5)
GRAD = dict(rtol=2e-4, atol=1e-7)


def _data(seed, b=2, h=32, w=48, holes=True):
    """tests/test_kernels.py's inputs: uniform depth, 20% holes."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(1, 79, size=(b, h, w)).astype(np.float32)
    gt = rng.uniform(1, 79, size=(b, h, w)).astype(np.float32)
    mask = ((rng.uniform(size=(b, h, w)) > 0.2).astype(np.float32) if holes
            else np.ones((b, h, w), np.float32))
    return pred, gt, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# -------------------------------------------------------------------- ssim

@pytest.mark.parametrize("n", [6, 11, 16, 37, 53])
def test_gaussian_and_blur_matrix_equal_jax(n):
    np.testing.assert_array_equal(tssim.gaussian_kernel_1d(), jssim.gaussian_kernel_1d())
    np.testing.assert_array_equal(tssim.blur_matrix(n), jssim.blur_matrix(n))


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("hw", [(16, 24), (37, 53)])
def test_ssim_matches_jax(hw, mean):
    p, g, _ = _data(1, 2, *hw)
    p, g = p / 80.0, g / 80.0
    got = tssim.ssim(*_t(p, g), mean=mean)
    want = jssim.ssim(jnp.asarray(p), jnp.asarray(g), mean=mean, precision="highest")
    # abs 2e-5: the JAX suite's bound for SSIM summed in another order
    # (tests/test_losses.py, against a conv oracle)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_ssim_rejects_unknown_precision():
    x = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="precision"):
        tssim.ssim(x, x, precision="bf16")


# ------------------------------------------------------------- fused loss

def _port_terms(pred, gt, mask, **kw):
    return {k: float(v) for k, v in tfl.fused_loss_terms(*_t(pred, gt, mask), 80.0, **kw).items()}


@pytest.mark.parametrize("shape", [(2, 32, 48), (3, 37, 53), (1, 11, 16)])
def test_fused_forward_matches_jax_kernel(shape):
    pred, gt, mask = _data(sum(shape), *shape)
    want = j_fused(*map(jnp.asarray, (pred, gt, mask)), 80.0, interpret=True)
    got = _port_terms(pred, gt, mask)
    for k in ("recon", "grad0", "ssim"):
        assert got[k] == pytest.approx(float(want[k]), **VAL), k


def test_fused_forward_4d_inputs():
    pred, gt, mask = _data(2, b=1)
    f3 = _port_terms(pred, gt, mask)
    f4 = _port_terms(pred[..., None], gt[..., None], mask[..., None])
    assert f3 == f4


def _grad_pair(pred, gt, mask, weights=(1.0, 0.7, 0.4)):
    w_r, w_g, w_s = weights

    def j_total(p):
        t = j_fused(p, jnp.asarray(gt), jnp.asarray(mask), 80.0, interpret=True)
        return w_r * t["recon"] + w_g * t["grad0"] + w_s * t["ssim"]

    want = np.asarray(jax.grad(j_total)(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    t = tfl.fused_loss_terms(p, *_t(gt, mask), 80.0)
    (w_r * t["recon"] + w_g * t["grad0"] + w_s * t["ssim"]).backward()
    return p.grad.numpy(), want


@pytest.mark.parametrize("shape", [(2, 24, 32), (3, 37, 53), (2, 11, 16)])
def test_fused_gradient_matches_jax_kernel(shape):
    """Odd and small shapes: edge rows (where the transposed reflect
    blur folds) are a large share of the image."""
    pred, gt, mask = _data(7 + shape[1], *shape)
    got, want = _grad_pair(pred, gt, mask)
    np.testing.assert_allclose(got, want, **GRAD)


def test_fused_gradient_perfect_pred_is_zero():
    _, gt, mask = _data(3, b=1, h=16, w=24, holes=False)
    got, want = _grad_pair(gt.copy(), gt, mask, weights=(1.0, 1.0, 1.0))
    np.testing.assert_allclose(got, 0.0, atol=1e-6)
    np.testing.assert_allclose(want, 0.0, atol=1e-6)


def test_fused_all_masked_image_is_dropped_from_ssim():
    pred, gt, mask = _data(5, b=3, h=16, w=24)
    mask[1] = 0.0
    want = j_fused(*map(jnp.asarray, (pred, gt, mask)), 80.0, interpret=True)
    got = _port_terms(pred, gt, mask)
    for k in ("recon", "grad0", "ssim"):
        assert got[k] == pytest.approx(float(want[k]), **VAL), k
    # the SSIM term equals that of the two valid images alone
    keep = [0, 2]
    alone = _port_terms(pred[keep], gt[keep], mask[keep])
    assert got["ssim"] == pytest.approx(alone["ssim"], rel=1e-6)
    g, gw = _grad_pair(pred, gt, mask)
    np.testing.assert_allclose(g, gw, **GRAD)
    assert np.abs(g[1]).max() == 0.0


def test_bwd_plain_equals_autograd_of_normalized_terms():
    """fused_loss_bwd_plain (the card's reference for the backward
    kernel) with the cotangents of _cotangents gives the gradient of the
    normalized terms."""
    pred, gt, mask = _data(9, b=2, h=16, w=24)
    mask[0, :3] = 0.0
    p = torch.from_numpy(pred).requires_grad_(True)
    raw = tfl.loss_sums_plain(p, *_t(gt, mask), 80.0)
    ct = torch.tensor([1.0, 0.7, 0.4])
    (tfl._normalize(raw) * ct).sum().backward()
    d = tfl.fused_loss_bwd_plain(*_t(pred, gt, mask), tfl._cotangents(raw.detach(), ct), 80.0)
    np.testing.assert_allclose(d.numpy(), p.grad.numpy(), rtol=1e-6, atol=1e-12)


def test_fused_wrappers_check_inputs():
    pred, gt, mask = _t(*_data(4, b=1, h=8, w=8))
    with pytest.raises(ValueError, match="device"):
        tfl.fused_loss_fwd(pred, gt, mask, 80.0)
    with pytest.raises(ValueError, match="device"):
        tfl.fused_loss_bwd(pred, gt, mask, torch.zeros(1, 4), 80.0)
    with pytest.raises(TypeError, match="dtype"):
        tfl.fused_loss_terms(pred.int(), gt, mask, 80.0)
    with pytest.raises(ValueError, match="one shape"):
        tfl.fused_loss_terms(pred, gt[:, :4], mask, 80.0)
    with pytest.raises(ValueError, match="precision"):
        tfl.fused_loss_terms(pred, gt, mask, 80.0, precision="fast")
    before = (tfl.fused_loss_fwd.launches, tfl.fused_loss_bwd.launches)
    p = pred.clone().requires_grad_(True)
    tfl.fused_loss_terms(p, gt, mask, 80.0)["ssim"].backward()
    assert (tfl.fused_loss_fwd.launches, tfl.fused_loss_bwd.launches) == before


_BAD_MAPS = {
    "bf16 pred": (lambda p, g, m: (p.bfloat16(), g, m), TypeError, "float32"),
    "float64 mask": (lambda p, g, m: (p, g, m.double()), TypeError, "float32"),
    "strided gt": (lambda p, g, m: (p, g.transpose(1, 2).contiguous().transpose(1, 2), m),
                   ValueError, "contiguous"),
    "ragged mask": (lambda p, g, m: (p, g, m[:, :, :6]), ValueError, "one shape"),
    "4-D maps": (lambda p, g, m: (p[..., None], g[..., None], m[..., None]),
                 ValueError, "one shape"),
    "gt elsewhere": (lambda p, g, m: (p, g.to("meta"), m), ValueError, "one device"),
}


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("case", list(_BAD_MAPS))
def test_fused_kernel_wrappers_refuse_unsupported_maps(case, bwd):
    """The raw kernel wrappers hand data_ptr()s of fp32 dense maps to the
    kernels: any other dtype, layout, shape or device mix is refused
    before a launch (checked ahead of the CUDA-device check)."""
    make, err, msg = _BAD_MAPS[case]
    pred, gt, mask = make(*_t(*_data(4, b=2, h=8, w=10)))
    before = (tfl.fused_loss_fwd.launches, tfl.fused_loss_bwd.launches)
    with pytest.raises(err, match=msg):
        if bwd:
            tfl.fused_loss_bwd(pred, gt, mask, torch.zeros(2, 4), 80.0)
        else:
            tfl.fused_loss_fwd(pred, gt, mask, 80.0)
    assert (tfl.fused_loss_fwd.launches, tfl.fused_loss_bwd.launches) == before


# -------------------------------------------------------------- total_loss

def _latents(seed, b=2):
    rng = np.random.default_rng(seed)
    shapes = [(b, 2, 3, 16), (b, 4, 6, 8), (b, 8, 12, 4)]
    a = [rng.normal(size=s).astype(np.float32) for s in shapes]
    t = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return a, t


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_total_loss_matches_jax(use_pallas, stage):
    pred, gt, mask = _data(11 + stage, b=2, h=32, w=48)
    mask[1] = 0.0 if stage == 2 else mask[1]
    pred, gt, mask = pred[..., None], gt[..., None], mask[..., None]
    a, t = _latents(stage) if stage == 2 else ([], [])
    jc = jcfg.LossConfig()
    tc = tcfg.LossConfig(use_pallas=use_pallas)

    def j_total(p):
        terms = jl.total_loss(p, jnp.asarray(gt), jnp.asarray(mask), jc, 80.0,
                              [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in t])
        return terms["total"], terms

    (_, jterms), jgrad = jax.jit(jax.value_and_grad(j_total, has_aux=True))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    terms = tl.total_loss(p, *_t(gt, mask), tc, 80.0, _t(*a), _t(*t))
    terms["total"].backward()
    assert set(terms) == set(jterms)
    for k in jterms:
        assert float(terms[k].detach()) == pytest.approx(float(jterms[k]), **VAL), k
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), **GRAD)


def test_loss_pieces_match_jax():
    pred, gt, mask = _data(21, b=2, h=20, w=30)
    jp, jg, jm = map(jnp.asarray, (pred, gt, mask))
    tp, tg, tm = _t(pred, gt, mask)
    assert float(tl.masked_l1(tp, tg, tm)) == pytest.approx(float(jl.masked_l1(jp, jg, jm)), **VAL)
    for n in (1, 3):
        assert float(tl.gradient_loss(tp, tg, tm, n)) == pytest.approx(
            float(jl.gradient_loss(jp, jg, jm, n)), **VAL)
    np.testing.assert_allclose(tl._avgpool2(tp).numpy(), np.asarray(jl._avgpool2(jp)), rtol=1e-6)
    w = np.array([1.0, 0.0], np.float32)
    assert float(tl.ssim_loss(tp, tg, 80.0, image_weights=torch.from_numpy(w))) == pytest.approx(
        float(jl.ssim_loss(jp, jg, 80.0, image_weights=jnp.asarray(w))), **VAL)
    a, t = _latents(3)
    assert float(tl.latent_loss(_t(*a), _t(*t))) == pytest.approx(
        float(jl.latent_loss([jnp.asarray(x) for x in a], [jnp.asarray(x) for x in t])), **VAL)
    with pytest.raises(ValueError, match="depth"):
        tl.latent_loss(_t(*a), _t(*t)[:2])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.total_loss(tp, tg, tm, tcfg.LossConfig(), 80.0, scale_preds=[tp])


# ------------------------------------------------------- GroupNorm + ELU

GN_SHAPES = [(3, 10, 14, 16, 4), (2, 16, 32, 32, 8), (1, 6, 8, 16, 8)]
GN_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=0.05, atol=0.05)}


def _gn_inputs(shape, seed):
    b, h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    da = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return x, scale, bias, da


@functools.lru_cache(maxsize=None)
def _jax_gn(shape, dtype):
    """Output and vjp of the JAX package's analytic GN+ELU (numpy),
    shared by the port's two entry points."""
    x, scale, bias, da = _gn_inputs(shape, seed=sum(shape))
    jdt = getattr(jnp, dtype)

    @jax.jit
    def run(y, s, b, d):
        out, vjp = jax.vjp(
            lambda y, s, b: jgn.group_norm_elu_analytic(y, s, b, shape[-1]), y, s, b)
        return (out, *vjp(d))

    res = run(jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias),
              jnp.asarray(da).astype(jdt))
    return [np.asarray(r, np.float32) for r in res]


def _nchw(a, dtype):
    return torch.from_numpy(a).permute(0, 3, 1, 2).to(getattr(torch, dtype))


@pytest.mark.parametrize("fn", ["analytic", "wrapper"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_gn_elu_backward_matches_jax_vjp(shape, dtype, fn):
    x, scale, bias, da = _gn_inputs(shape, seed=sum(shape))
    groups = shape[-1]
    out, jdx, jds, jdb = _jax_gn(shape, dtype)
    xt = _nchw(x, dtype).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    f = tgn.group_norm_elu_analytic if fn == "analytic" else group_norm_elu
    y = f(xt, st, bt, groups)
    assert y.grad_fn is not None
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).float().numpy(),
                               out, **GN_TOL[dtype])
    y.backward(_nchw(da, dtype))
    assert xt.grad.dtype == xt.dtype and st.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).float().numpy(),
                               jdx, **GN_TOL[dtype])
    np.testing.assert_allclose(st.grad.numpy(), jds, **GN_TOL[dtype])
    np.testing.assert_allclose(bt.grad.numpy(), jdb, **GN_TOL[dtype])


def test_gn_elu_analytic_forward_equals_plain():
    x, scale, bias, _ = _gn_inputs(GN_SHAPES[0], seed=1)
    for dtype in ("float32", "bfloat16"):
        args = (_nchw(x, dtype), torch.from_numpy(scale), torch.from_numpy(bias), 4)
        assert torch.equal(tgn.group_norm_elu_analytic(*args), tgn.group_norm_elu_plain(*args))


def test_gn_elu_no_grad_keeps_no_graph():
    x, scale, bias, _ = _gn_inputs(GN_SHAPES[1], seed=2)
    xt = _nchw(x, "float32").requires_grad_(True)
    with torch.no_grad():
        y = group_norm_elu(xt, torch.from_numpy(scale), torch.from_numpy(bias), 8)
    assert y.grad_fn is None
