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
from gdn_tpu.kernels import fused_loss as jfl
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


# ------------------------------------------ the one-launch forward's tiling

def _fwd_tiled(pred, gt, mask, max_val, window=11, sigma=1.5, grid=5):
    """The (B, 8) sums by the forward kernel's dataflow, in fp32 PyTorch:
    the (image, ``FWD_TILE`` tile) jobs walked as ``fwd_plan`` deals them
    to ``grid`` blocks; per tile raw pred and gt staged with a halo of
    max(half, 1) and the mask with 1 (reflect index once a row and once a
    column), L1 and the forward differences from the staged raw values
    (left/top ownership), the moments of the staged maps times 1/max rows
    then columns, the SSIM map summed; each tile's 7 sums into a (B,
    tiles, 8) scratch, folded per image in tile order."""
    b, h, w = pred.shape
    th, tw = tfl.FWD_TILE
    half = window // 2
    sh = max(half, 1)
    t0 = sh - half
    wt = torch.from_numpy(tssim.gaussian_kernel_1d(window, sigma))
    plan = tfl.fwd_plan(b, h, w, grid)
    tiles = plan.tiles_y * plan.tiles_x
    partials = torch.full((b, tiles, 8), float("nan"))
    for job in (j for k in range(plan.grid) for j in range(k, b * tiles, plan.grid)):
        bi, tile = divmod(job, tiles)
        r0, c0 = tile // plan.tiles_x * th, tile % plan.tiles_x * tw
        rix = _reflect(np.arange(r0 - sh, r0 + th + sh), h)
        cix = _reflect(np.arange(c0 - sh, c0 + tw + sh), w)
        sp, sg = pred[bi][rix][:, cix], gt[bi][rix][:, cix]
        sm = mask[bi][rix[sh:sh + th + 1]][:, cix[sh:sh + tw + 1]]
        nr, nc = min(th, h - r0), min(tw, w - c0)
        p, g, m = sp[sh:sh + nr, sh:sh + nc], sg[sh:sh + nr, sh:sh + nc], sm[:nr, :nc]
        d = p - g
        dx = (sp[sh:sh + nr, sh + 1:sh + nc + 1] - p) - (sg[sh:sh + nr, sh + 1:sh + nc + 1] - g)
        dy = (sp[sh + 1:sh + nr + 1, sh:sh + nc] - p) - (sg[sh + 1:sh + nr + 1, sh:sh + nc] - g)
        mdx = sm[:nr, 1:nc + 1] * m
        mdy = sm[1:nr + 1, :nc] * m
        cols = torch.arange(c0, c0 + nc)[None, :] + 1 < w  # owned: the right pixel is in
        rows = torch.arange(r0, r0 + nr)[:, None] + 1 < h
        mdx, mdy = mdx * cols, mdy * rows
        pn, gn = sp * (1.0 / max_val), sg * (1.0 / max_val)
        hm = [_stencil(v, wt, half, 1, t0, tw) for v in (pn, gn, pn * pn, gn * gn, pn * gn)]
        mx, my, mxx, myy, mxy = (_stencil(v, wt, half, 0, t0, th)[:nr, :nc] for v in hm)
        sxx = torch.clamp(mxx - mx * mx, min=0.0)
        syy = torch.clamp(myy - my * my, min=0.0)
        sxy = mxy - mx * my
        s = ((2.0 * mx * my + tfl.C1) * (2.0 * sxy + tfl.C2)) / (
            (mx * mx + my * my + tfl.C1) * (sxx + syy + tfl.C2))
        partials[bi, tile, :7] = torch.stack([
            (d.abs() * m).sum(), m.sum(), (dx.abs() * mdx).sum(), mdx.sum(),
            (dy.abs() * mdy).sum(), mdy.sum(), s.sum()])
    out = torch.zeros((b, 8))
    for t in range(tiles):
        out[:, :7] += partials[:, t, :7]
    out[:, 7] = float(h * w)
    return out


def _jax_raw(pred, gt, mask, window=11):
    """The (B, 8) sums of the JAX package's Pallas forward in interpret
    mode (the residual its custom VJP keeps)."""
    _, (_, _, _, raw) = jfl._fused_terms_fwd(
        *map(jnp.asarray, (pred, gt, mask)), 80.0, window, 1.5, True, pred.shape[1:],
        "highest")
    return np.asarray(raw)


_FWD_SHAPES = [(2, 24, 32), (3, 37, 53), (2, 11, 16), (1, 6, 6), (2, 80, 200)]


@pytest.mark.parametrize("shape,window", [(s, 11) for s in _FWD_SHAPES] + [((2, 80, 200), 7)])
def test_one_launch_forward_tiling_matches_jax_kernel(shape, window):
    """The forward kernel's dataflow (tiles of FWD_TILE, raw maps staged
    with the half-window's halo, L1 and differences from the staged
    values, rows then columns, the per-image fold in tile order) against
    the JAX Pallas kernel's (B, 8) sums in interpret mode; (2, 80, 200)
    is three tile rows by four tile columns an image, ragged in both
    directions, with interior tiles."""
    pred, gt, mask = _data(11 + shape[2], *shape)
    got = _fwd_tiled(*_t(pred, gt, mask), 80.0, window)
    want = _jax_raw(pred, gt, mask, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=VAL["rel"])


_PLAN_SHAPES = _FWD_SHAPES + [(32, 128, 416)]


@pytest.mark.parametrize("resident", [1, 5, 7, 264, 528, 10_000])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_forward_plan_visits_every_tile_once(shape, resident):
    """fwd_plan: every (image, tile) job once, tiles covering the image
    with ragged last ones, never more blocks than resident, none idle,
    and the scratch (B, tiles, 8)."""
    b, h, w = shape
    th, tw = tfl.FWD_TILE
    plan = tfl.fwd_plan(b, h, w, resident)
    assert (plan.tiles_y - 1) * th < h <= plan.tiles_y * th
    assert (plan.tiles_x - 1) * tw < w <= plan.tiles_x * tw
    total = b * plan.tiles_y * plan.tiles_x
    assert 1 <= plan.grid <= min(resident, total)
    seen = np.zeros(total, int)
    for k in range(plan.grid):
        jobs = list(range(k, total, plan.grid))
        assert 1 <= len(jobs) <= plan.tiles_per_block
        seen[jobs] += 1
    assert (seen == 1).all()
    if shape == (32, 128, 416) and resident == 264:  # two blocks on each of 132 SMs
        assert plan == tfl.FwdPlan(4, 7, 264, 4)


def test_forward_plan_refuses_no_resident_block():
    with pytest.raises(ValueError, match="blocks"):
        tfl.fwd_plan(1, 8, 8, 0)


# ----------------------------------------- the one-launch backward's tiling

def _reflect(j, n):
    """The kernel's staging index: reflect-101, then clamped (exact for
    -n < j < 2n - 1; farther positions feed no output)."""
    j = np.abs(j)
    j = np.where(j >= n, 2 * n - 2 - j, j)
    return np.clip(j, 0, n - 1)


def _fold_taps(w, half, j, n, x):
    """The folded reflect-101 taps of the transposed blur at output j of a
    line of n (the kernel's fold_taps); x(i) reads the map at pixel i."""
    v = 0.0
    if 1 <= j <= half:
        for i in range(0, half - j + 1):
            v = v + w[half - i - j] * x(i)
    if n - 1 - half <= j <= n - 2:
        for i in range(max(2 * n - 2 - j - half, 0), n):
            v = v + w[2 * n - 2 - j + half - i] * x(i)
    return v


def _stencil(a, w, half, axis, start, count):
    """sum_t w[t] a[start + t + k] along ``axis``, k < count (the plain
    11-tap stencil of the kernel's shared-memory passes)."""
    out = 0.0
    for t in range(2 * half + 1):
        out = out + w[t] * a.narrow(axis, start + t, count)
    return out


def _bwd_tiled(pred, gt, mask, cts, max_val, window=11, sigma=1.5):
    """dL/dpred by the backward kernel's dataflow, in fp32 PyTorch: per
    output tile of ``BWD_TILE``, pred/max and gt/max staged with a
    ``BWD_HALO``-pixel halo (reflect index once a row and once a column),
    the moments and the three adjoint maps for the tile plus 5 only (0
    outside the image), the transposed blur rows then columns with the
    folded taps only in tiles within ``half`` of an edge, then the L1 and
    difference terms.  Returns (dpred, interior tiles seen, and whether
    every interior tile's plain stencil equalled blur_t's result)."""
    b, h, w = pred.shape
    th, tw = tfl.BWD_TILE
    halo, hh = tfl.BWD_HALO, tfl.BWD_HALO // 2
    half = window // 2
    wt = torch.from_numpy(tssim.gaussian_kernel_1d(window, sigma))
    t0 = hh - half
    inv = 1.0 / max_val
    pn, gn = pred * inv, gt * inv
    dpred = torch.zeros_like(pred)
    interior, agree = 0, True
    for bi in range(b):
        for r0 in range(0, h, th):
            for c0 in range(0, w, tw):
                rix = _reflect(np.arange(r0 - halo, r0 + th + halo), h)
                cix = _reflect(np.arange(c0 - halo, c0 + tw + halo), w)
                sp = pn[bi][rix][:, cix]
                sg = gn[bi][rix][:, cix]
                mc = tw + 2 * hh
                hm = [_stencil(v, wt, half, 1, t0, mc)
                      for v in (sp, sg, sp * sp, sg * sg, sp * sg)]
                mr = th + 2 * hh
                mx, my, mxx, myy, mxy = (_stencil(v, wt, half, 0, t0, mr) for v in hm)
                sxx = torch.clamp(mxx - mx * mx, min=0.0)
                syy = torch.clamp(myy - my * my, min=0.0)
                sxy = mxy - mx * my
                n1, n2 = 2.0 * mx * my + tfl.C1, 2.0 * sxy + tfl.C2
                d1, d2 = mx * mx + my * my + tfl.C1, sxx + syy + tfl.C2
                s = (n1 * n2) / (d1 * d2)
                a1 = 2.0 * my * n2 / (d1 * d2) - s * 2.0 * mx / d1
                a3 = -s / d2
                a5 = 2.0 * n1 / (d1 * d2)
                rows = torch.arange(r0 - hh, r0 + th + hh)[:, None]
                cols = torch.arange(c0 - hh, c0 + tw + hh)[None, :]
                inside = ((rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)).float()
                maps = [(a1 - 2.0 * mx * a3 - my * a5) * inside, a3 * inside, a5 * inside]
                fx = c0 <= half or c0 + tw + half + 1 > w
                fy = r0 <= half or r0 + th + half + 1 > h
                interior += not (fx or fy)
                tk = []
                for m in maps:
                    # the zero-padded stencil: taps w[half - d] at tc + hh + d
                    ht = _stencil(m, wt.flip(0), half, 1, t0, tw)
                    folded = ht.clone()
                    for tc in range(tw):
                        folded[:, tc] += _fold_taps(
                            wt, half, c0 + tc, w, lambda i: m[:, i - c0 + hh])
                    agree &= fx or torch.equal(folded, ht)
                    ht = folded if fx else ht
                    v = _stencil(ht, wt.flip(0), half, 0, t0, th)
                    folded = v.clone()
                    for tr in range(th):
                        folded[tr] += _fold_taps(
                            wt, half, r0 + tr, h, lambda i: ht[i - r0 + hh])
                    agree &= fy or torch.equal(folded, v)
                    tk.append(folded if fy else v)
                r1, c1 = min(r0 + th, h), min(c0 + tw, w)
                p, g = pred[bi, r0:r1, c0:c1], gt[bi, r0:r1, c0:c1]
                dpred[bi, r0:r1, c0:c1] = cts[bi, 3] * inv * (
                    tk[0][:r1 - r0, :c1 - c0] + 2.0 * (p * inv) * tk[1][:r1 - r0, :c1 - c0]
                    + (g * inv) * tk[2][:r1 - r0, :c1 - c0])
    # the L1 sign field and the scatter of the forward-difference signs
    d = pred - gt
    dpred += cts[:, 0, None, None] * torch.sign(d) * mask
    sx = torch.sign(d[:, :, 1:] - d[:, :, :-1]) * mask[:, :, 1:] * mask[:, :, :-1]
    sy = torch.sign(d[:, 1:] - d[:, :-1]) * mask[:, 1:] * mask[:, :-1]
    gx, gy = torch.zeros_like(pred), torch.zeros_like(pred)
    gx[:, :, 1:] += sx
    gx[:, :, :-1] -= sx
    gy[:, 1:] += sy
    gy[:, :-1] -= sy
    dpred += cts[:, 1, None, None] * gx + cts[:, 2, None, None] * gy
    return dpred, interior, agree


@pytest.mark.parametrize("shape", [(2, 24, 32), (3, 37, 53), (2, 11, 16), (2, 80, 200)])
def test_one_launch_backward_tiling_matches_jax_kernel(shape):
    """The backward kernel's tiling (tile + 10 staged, maps on tile + 5
    only, interior tiles on the plain stencil) against the gradient of the
    JAX Pallas kernel in interpret mode; (2, 80, 200) is three tile rows
    by four tile columns an image, two of them interior."""
    weights = (1.0, 0.7, 0.4)
    pred, gt, mask = _data(7 + shape[1], *shape)
    _, want = _grad_pair(pred, gt, mask, weights)
    p, g, m = _t(pred, gt, mask)
    raw = tfl.loss_sums_plain(p, g, m, 80.0)
    # ssim = (1 - ssim_mean) / 2, so its weight enters as -w / 2
    ct = torch.tensor([weights[0], weights[1], -weights[2] / 2])
    got, interior, agree = _bwd_tiled(p, g, m, tfl._cotangents(raw, ct), 80.0)
    np.testing.assert_allclose(got.numpy(), want, **GRAD)
    assert agree  # blur_t's folded taps add nothing on interior tiles
    assert interior == (4 if shape == (2, 80, 200) else 0)


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
    # the multi-scale heads' term, once refused: total_loss adds it as JAX does
    coarse = [tp[:, ::2, ::2], tp[:, ::4, ::4]]
    got = tl.total_loss(tp, tg, tm, tcfg.LossConfig(), 80.0, scale_preds=coarse)
    want = jl.total_loss(jp, jg, jm, jcfg.LossConfig(), 80.0,
                         scale_preds=[jnp.asarray(c.numpy()) for c in coarse])
    assert set(got) == set(want) and "scales" in got
    for k in ("scales", "total"):
        assert float(got[k]) == pytest.approx(float(want[k]), **VAL), k


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
