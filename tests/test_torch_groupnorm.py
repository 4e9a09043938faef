"""GroupNorm+ELU of the PyTorch port against the JAX package.

On the CPU the port's ``group_norm_elu`` runs its plain version; it is
held to the TPU kernel run in interpret mode and to the analytic XLA
form, on the same numpy inputs, at the shapes and tolerances of
tests/test_kernels.py (fp32 rtol 1e-4 / atol 1e-5; bf16 atol 0.05, the
bound the JAX suite gives the kernel against its reference).

The CUDA kernel itself runs only on the card (``chip_smoke.py``); here
its plan (``gn_plan``: every row in one slab, every slab in one block,
no more blocks than are resident, held at every serving site, streamed
at the 128x416 training sites) is checked at the H100's shared-memory
sizes, and a plain-PyTorch model of its dataflow (slab partials, a
fixed-order fold to the (B, 2, G) mean and inverse std) is held to the
TPU kernel in interpret mode, its statistics to the JAX package's fp32
ones (rtol 1e-5 / atol 1e-6, as on the card), and the split form's
plain backward from those statistics to ``jax.vjp``.  The backward
kernel's plan (``gn_plan`` on x's and da's rows at its own slab space:
every row once, no more blocks than are resident, at the KITTI and NYU
training sites at B=128 and B=96) and a plain model of its dataflow
(slab partials, their fixed-order folds, held and streamed plans, a
cotangent of row pitch > C) are held the same way, the model to
``jax.vjp``.
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


def test_cpu_backward_counts_no_launch():
    before = (group_norm_elu.launches, group_norm_elu.backward_launches)
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    params = [x.requires_grad_(True), torch.ones(8, requires_grad=True),
              torch.zeros(8, requires_grad=True)]
    group_norm_elu(*params, 4).square().sum().backward()
    assert all(p.grad is not None for p in params)
    assert (group_norm_elu.launches, group_norm_elu.backward_launches) == before


# ------------------------------------------- the one-launch kernel's plan

from gdn_tpu_torch.kernels import groupnorm as gnk  # noqa: E402

H100_SMEM_PER_SM, H100_RESERVED = 233_472, 1_024  # bytes (cudaDevAttr...)
SMS = 132
RESIDENT = 2 * SMS  # the two blocks an SM the slab is sized for
# The distinct GroupNorm+ELU sites of the KITTI G-net (C, H, W) and how many
# of its 21 sites each is (chip_smoke.gn_sites).
KITTI_SITES = [(512, 4, 13, 2), (256, 8, 26, 4), (128, 16, 52, 4), (64, 32, 104, 4),
               (32, 64, 208, 4), (16, 128, 416, 2), (32, 128, 416, 1)]
PLAN_RAGGED = [  # (B, HW, C, groups, itemsize, vec, resident)
    (3, 63, 16, 4, 2, 8, RESIDENT), (2, 15, 1024, 32, 2, 8, RESIDENT),
    (2, 15, 1024, 8, 4, 1, RESIDENT), (4, 1, 64, 8, 2, 8, RESIDENT),
    (2, 143, 12, 4, 2, 1, RESIDENT), (300, 7, 32, 8, 2, 8, RESIDENT),
    (8, 256 * 416, 32, 8, 2, 8, RESIDENT), (5, 1000, 48, 8, 4, 4, 7),
    (1, 6, 1024, 8, 4, 1, 1),
]


# The same for the NYU G-net (228x304).
NYU_SITES = [(512, 8, 10, 2), (256, 15, 19, 4), (128, 29, 38, 4), (64, 57, 76, 4),
             (32, 114, 152, 4), (16, 228, 304, 2), (32, 228, 304, 1)]


def _capacity(c, groups, vec):
    return gnk.slab_capacity(c, groups, vec, H100_SMEM_PER_SM, H100_RESERVED)


def _bwd_capacity(c, vec):
    return gnk.bwd_slab_capacity(c, vec, H100_SMEM_PER_SM, H100_RESERVED)


def _check_plan(b, hw, c, groups, item, vec, resident, bwd=False):
    """The plan of the forward (``bwd``: the backward, which stages x and
    da, ``item`` bytes each) checked as the kernel needs it."""
    cap = _bwd_capacity(c, vec) if bwd else _capacity(c, groups, vec)
    row_item = 2 * item if bwd else item
    plan = gnk.gn_plan(b, hw, c, row_item, resident, cap, SMS)
    spi, rows = plan.slabs_per_image, plan.rows
    # every row of every image in exactly one slab
    assert (spi - 1) * rows < hw <= spi * rows
    covered = np.zeros((b, hw), np.int64)
    for s in range(b * spi):
        covered[s // spi, (s % spi) * rows:(s % spi + 1) * rows] += 1
    assert (covered == 1).all()
    # every slab in exactly one block, none beyond the resident grid
    assert 1 <= plan.grid <= resident
    walks = [len(range(i, b * spi, plan.grid)) for i in range(plan.grid)]
    assert sum(walks) == b * spi and max(walks) == plan.slabs_per_block
    assert min(walks) >= 1
    assert plan.held == (plan.slabs_per_block == 1)
    # a held slab within the space, a streamed one within half of it
    assert rows * c * row_item <= (cap if plan.held else cap // 2 // 16 * 16)
    # two blocks' dynamic shared memory fit an SM
    smem = gnk.bwd_smem_bytes(c, vec, cap) if bwd else gnk.smem_bytes(c, groups, vec, cap)
    per_block = smem + H100_RESERVED
    assert 2 * per_block <= H100_SMEM_PER_SM
    return plan


@pytest.mark.parametrize("item", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("site", KITTI_SITES, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_gn_plan_covers_every_row_once_at_kitti_sites(site, b, item):
    c, h, w, _ = site
    plan = _check_plan(b, h * w, c, 8, item, 16 // item, RESIDENT)
    if b == 8 and item == 2:
        assert plan.held  # every serving site stays in shared memory
        # one block an SM where that holds the site (<= 14 MB), else two
        assert plan.grid <= (SMS if b * h * w * c * item <= SMS * _capacity(c, 8, 8)
                             else RESIDENT)
    if b == 32 and (h, w) == (128, 416):
        assert not plan.held and plan.slabs_per_block > 1


@pytest.mark.parametrize("case", PLAN_RAGGED, ids=lambda t: "-".join(map(str, t[:3])))
def test_gn_plan_covers_every_row_once_at_ragged_shapes(case):
    _check_plan(*case)


def test_gn_plan_never_exceeds_the_resident_grid():
    rng = np.random.default_rng(0)
    for _ in range(300):
        c = int(rng.choice([8, 16, 24, 48, 64, 512, 1024]))
        item = int(rng.choice([2, 4]))
        b, hw = int(rng.integers(1, 70)), int(rng.integers(1, 60000))
        resident = int(rng.choice([1, 3, 132, 264]))
        plan = _check_plan(b, hw, c, 8, item, 16 // item, resident)
        assert plan.grid <= resident


def test_gn_plan_refuses_a_slab_without_a_row():
    with pytest.raises(ValueError, match="no row"):
        gnk.gn_plan(2, 10, 1024, 4, RESIDENT, 4096)


def _gn_dataflow(x, scale, bias, groups, plan, eps=1e-6):
    """The kernel's dataflow in plain PyTorch on NHWC x (B, HW, C): each
    slab's per-channel then per-group fp32 sums, the fixed-order fold of
    an image's slab partials into the (B, 2, G) mean and inverse std,
    then normalize, affine and ELU in fp32 and one cast to x's dtype."""
    b, hw, c = x.shape
    cg, spi, rows = c // groups, plan.slabs_per_image, plan.rows
    xf = x.float()
    parts = torch.zeros(b, spi, groups, 2)
    for s in range(b * spi):
        slab = xf[s // spi, (s % spi) * rows:(s % spi + 1) * rows]
        for k, moment in enumerate((slab, slab * slab)):
            parts[s // spi, s % spi, :, k] = moment.sum(0).view(groups, cg).sum(-1)
    tot = torch.zeros(b, groups, 2)
    for k in range(spi):  # fixed order, every block alike
        tot += parts[:, k]
    n = hw * cg
    mean = tot[..., 0] / n
    inv = torch.rsqrt(torch.clamp(tot[..., 1] / n - mean * mean, min=0.0) + eps)
    stats = torch.stack([mean, inv], dim=1)  # (B, 2, G)
    st = stats.repeat_interleave(cg, dim=2)
    z = (xf - st[:, None, 0]) * (st[:, None, 1] * scale) + bias
    return F.elu(z).to(x.dtype), stats


@pytest.mark.parametrize("resident", [RESIDENT, 3], ids=["held", "streamed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_dataflow_matches_jax_kernel_and_statistics(shape, dtype, resident):
    import jax

    b, h, w, c, groups = shape
    x, scale, bias = _inputs(shape, seed=sum(shape) + 1)
    item = 2 if dtype == "bfloat16" else 4
    vec = 16 // item
    cap = _capacity(c, groups, vec) if resident == RESIDENT else 4 * c * item
    plan = gnk.gn_plan(b, h * w, c, item, resident, cap)
    assert plan.held == (resident == RESIDENT)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(b, h * w, c)
    got, stats = _gn_dataflow(xt, torch.from_numpy(scale), torch.from_numpy(bias),
                              groups, plan)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = fused_group_norm_elu(xj, jnp.asarray(scale), jnp.asarray(bias), groups,
                                1e-6, True)
    np.testing.assert_allclose(got.float().numpy().reshape(b, h, w, c),
                               np.asarray(want, np.float32), **TOL[dtype])
    # statistics: the JAX package's fp32 inverse std (the residual of its
    # analytic form) and the groups' mean of the same rounded inputs
    _, _, inv_c = jax.jit(jgn._gn_elu_impl, static_argnums=(3, 4))(
        xj, jnp.asarray(scale), jnp.asarray(bias), groups, 1e-6)
    cg = c // groups
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(inv_c)[:, ::cg],
                               rtol=1e-5, atol=1e-6)
    xr = np.asarray(xj.astype(jnp.float32), np.float64).reshape(b, h * w, groups, cg)
    np.testing.assert_allclose(stats[:, 0].numpy(), xr.mean(axis=(1, 3)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_backward_from_kernel_statistics_matches_jax_vjp(shape, dtype):
    """The split form's backward (``backward_from_stats``), fed the (B, 2,
    G) statistics as the kernel writes them (here by its dataflow model),
    against jax.vjp of the JAX package's analytic GroupNorm+ELU.  Its
    elementwise math is fp32 (as the backward kernel's) with one cast of
    dx, so its reference is the fp32 vjp on the same (bf16-rounded)
    inputs: the JAX package's bf16 vjp rounds dz and dz * yn to bf16
    before its sums and lands 0.06-0.22 from that reference on dscale
    here, farther than the tolerance."""
    import jax

    b, h, w, c, groups = shape
    x, scale, bias = _inputs(shape, seed=sum(shape) + 2)
    da = np.random.default_rng(sum(shape)).normal(size=x.shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt)
    plan = gnk.gn_plan(b, h * w, c, xt.element_size(), RESIDENT,
                       _capacity(c, groups, 16 // xt.element_size()))
    _, stats = _gn_dataflow(xt.reshape(b, h * w, c), torch.from_numpy(scale),
                            torch.from_numpy(bias), groups, plan)
    dx, dscale, dbias = gnk.backward_from_stats(
        _torch_nchw(da, dtype), _torch_nchw(x, dtype), stats, torch.from_numpy(scale),
        torch.from_numpy(bias), groups)
    _, vjp = jax.vjp(lambda y, s, bb: jgn.group_norm_elu_analytic(y, s, bb, groups),
                     jnp.asarray(x).astype(jdt).astype(jnp.float32), jnp.asarray(scale),
                     jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(da).astype(jdt).astype(jnp.float32))
    assert dx.dtype == tdt and dscale.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), np.asarray(jdx, np.float32), **TOL[dtype])
    np.testing.assert_allclose(dscale.numpy(), np.asarray(jds), **TOL[dtype])
    np.testing.assert_allclose(dbias.numpy(), np.asarray(jdb), **TOL[dtype])


# ------------------------------------------ the one-launch backward kernel


@pytest.mark.parametrize("site", [("kitti", 128, s) for s in KITTI_SITES]
                         + [("nyu", 96, s) for s in NYU_SITES],
                         ids=lambda t: f"{t[0]}-b{t[1]}-{t[2][0]}x{t[2][1]}x{t[2][2]}")
def test_bwd_plan_covers_every_row_once_at_training_sites(site):
    """The backward's plan at the stage-2 training sites (bf16 x and da):
    every row once, no more blocks than resident; the 128x416 and 228x304
    sites, 50 MB and more a tensor, stream."""
    _, b, (c, h, w, _) = site
    plan = _check_plan(b, h * w, c, 8, 2, 8, RESIDENT, bwd=True)
    if h >= 128:
        assert not plan.held and plan.slabs_per_block > 1


def test_bwd_plan_never_exceeds_the_resident_grid():
    rng = np.random.default_rng(1)
    for _ in range(100):
        c = int(rng.choice([8, 16, 24, 48, 64, 512, 1024]))
        item = int(rng.choice([2, 4]))
        b, hw = int(rng.integers(1, 140)), int(rng.integers(1, 60000))
        resident = int(rng.choice([1, 3, 132, 264]))
        plan = _check_plan(b, hw, c, 8, item, 16 // item, resident, bwd=True)
        assert plan.grid <= resident


_CL = torch.channels_last


@pytest.mark.parametrize("case", [
    ("channels_last", (2, 16, 5, 7), lambda t: t.contiguous(memory_format=_CL), 16),
    ("concat slice", (2, 16, 5, 7), lambda t: torch.cat(
        [t, torch.zeros(2, 8, 5, 7)], 1).contiguous(memory_format=_CL)[:, :16], 24),
    ("lateral slice", (2, 8, 5, 7), lambda t: torch.cat(
        [torch.zeros(2, 16, 5, 7), t], 1).contiguous(memory_format=_CL)[:, 16:], 24),
    ("W = 1", (3, 16, 5, 1), lambda t: torch.cat(
        [t, torch.zeros(3, 16, 5, 1)], 1).contiguous(memory_format=_CL)[:, :16], 32),
    ("H = W = 1", (3, 16, 1, 1), lambda t: t.contiguous(memory_format=_CL), 16),
    ("NCHW", (2, 16, 5, 7), lambda t: t.contiguous(), None),
    ("width slice", (2, 16, 5, 7), lambda t: torch.zeros(2, 16, 5, 9).contiguous(
        memory_format=_CL)[..., :7], None),
], ids=lambda t: t[0])
def test_row_pitch_reads_channels_last_and_channel_slices(case):
    """The backward reads a cotangent in place at its row pitch where it is
    channels_last or a channel slice of such a tensor (the gradient of a
    concat), and copies it otherwise (None)."""
    _, shape, make, want = case
    t = make(torch.randn(shape))
    assert t.shape == shape and gnk.row_pitch(t) == want


def _gn_bwd_dataflow(x, da, stats, scale, bias, groups, plan):
    """The backward kernel's dataflow in plain PyTorch on NHWC x (B, HW,
    C) and da (B, HW, pitch >= C; its first C channels): in block order,
    each slab's per-channel fp32 sums of dz and dz * yn, written as its
    per-group sums of scale_c times them and added, in the block's slab
    order, into the block's running (2, C) sum; the fold of an image's
    slab partials in slab order into m1, m2 over n; the blocks' sums
    added in block order into dbias and dscale; dx in fp32 and one cast.
    -> (dx, dscale, dbias)."""
    b, hw, c = x.shape
    cg, spi, rows, grid = c // groups, plan.slabs_per_image, plan.rows, plan.grid
    xf, df = x.float(), da[..., :c].float()
    st = stats.repeat_interleave(cg, dim=2)  # (B, 2, C)

    def dz_yn(img, sl):
        yn = (xf[img, sl] - st[img, 0]) * st[img, 1]
        z = yn * scale + bias
        return torch.where(z > 0, df[img, sl], df[img, sl] * torch.exp(z.clamp(max=0))), yn

    parts = torch.zeros(b * spi, groups, 2)
    blocks = torch.zeros(grid, 2, c)
    for blk in range(grid):
        for s in range(blk, b * spi, grid):
            dz, yn = dz_yn(s // spi, slice((s % spi) * rows, (s % spi + 1) * rows))
            sums = torch.stack([dz.sum(0), (dz * yn).sum(0)])  # (2, C)
            parts[s] = (scale * sums).view(2, groups, cg).sum(-1).T
            blocks[blk] += sums
    coef = torch.zeros(b, groups, 2)
    for k in range(spi):  # slab order
        coef += parts.view(b, spi, groups, 2)[:, k]
    coef /= hw * cg
    dsb = torch.zeros(2, c)
    for blk in range(grid):  # block order
        dsb += blocks[blk]
    m = coef.repeat_interleave(cg, dim=1)  # (B, C, 2)
    dx = torch.empty(b, hw, c)
    for img in range(b):
        dz, yn = dz_yn(img, slice(None))
        dx[img] = (dz * scale - m[img, :, 0] - yn * m[img, :, 1]) * st[img, 1]
    return dx.to(x.dtype), dsb[1], dsb[0]


@pytest.mark.parametrize("pitch", [0, 24], ids=["pitch_C", "pitch_C+24"])
@pytest.mark.parametrize("resident", [RESIDENT, 3], ids=["held", "streamed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernel_dataflow_matches_jax_vjp(shape, dtype, resident, pitch):
    """The backward kernel's dataflow, from the (B, 2, G) statistics of the
    forward's dataflow, against jax.vjp of the JAX package's analytic
    GroupNorm+ELU; a cotangent of row pitch C + 24 read from its first C
    channels (the rest is garbage the kernel must not read)."""
    import jax

    b, h, w, c, groups = shape
    x, scale, bias = _inputs(shape, seed=sum(shape) + 3)
    da = np.random.default_rng(sum(shape) + 4).normal(size=x.shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    item = 2 if dtype == "bfloat16" else 4
    vec = 16 // item
    xt = torch.from_numpy(x).to(tdt).reshape(b, h * w, c)
    fwd_plan = gnk.gn_plan(b, h * w, c, item, RESIDENT, _capacity(c, groups, vec))
    _, stats = _gn_dataflow(xt, torch.from_numpy(scale), torch.from_numpy(bias), groups,
                            fwd_plan)
    cap = _bwd_capacity(c, vec) if resident == RESIDENT else 4 * c * 2 * item
    plan = gnk.gn_plan(b, h * w, c, 2 * item, resident, cap)
    assert plan.held == (resident == RESIDENT)
    wide = np.full((b, h * w, c + pitch), 1e4, np.float32)
    wide[..., :c] = da.reshape(b, h * w, c)
    dx, dscale, dbias = _gn_bwd_dataflow(
        xt, torch.from_numpy(wide).to(tdt), stats, torch.from_numpy(scale),
        torch.from_numpy(bias), groups, plan)
    _, vjp = jax.vjp(lambda y, s, bb: jgn.group_norm_elu_analytic(y, s, bb, groups),
                     jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(da).astype(jdt))
    assert dx.dtype == tdt and dscale.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy().reshape(b, h, w, c),
                               np.asarray(jdx, np.float32), **TOL[dtype])
    np.testing.assert_allclose(dscale.numpy(), np.asarray(jds, np.float32), **TOL[dtype])
    np.testing.assert_allclose(dbias.numpy(), np.asarray(jdb, np.float32), **TOL[dtype])
