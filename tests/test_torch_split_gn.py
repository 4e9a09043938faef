"""The split GN+ELU kernel (``gn_rows_sums`` + ``gn_rows_apply``, the form
of GroupNorm+ELU for an image whose rows are sharded over spatial ranks)
in plain PyTorch on the CPU.

The kernels run only on the card (``chip_smoke.py`` phases 28 and 29).
Here:

- ``rows_plan``: every row of every image in one slab, every slab in one
  block, no more blocks than the card holds at once, and slabs of one
  unrolled trip (``ROWS_UNROLL`` rows a thread row) where the card holds
  that many blocks, so the small sites take a few blocks of many rows;
- the row indexing of both kernels' unrolled loops (the sums' forward
  trips, the apply's reverse ones): each row of a slab read once;
- a plain model of the dataflow: each slab's per-channel then per-group
  fp32 partials, the fold of an image's partials in slab order by the
  block that takes its last ticket (in any order the blocks finish:
  the same bits), the (B, G, 2) sums summed over the ranks, then the
  apply on the plan's slabs in reverse.  It is held to the port's plain
  version (``_rows_plain`` on the whole image) and its statistics to the
  JAX package's fp32 ones (rtol 1e-5 / atol 1e-6, as on the card), in
  fp32 and bf16, at the seven site shapes a spatial rank of the KITTI
  net holds, on NYU's 228-row image over two ranks (uneven shards) and
  where a rank holds no row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gdn_tpu.ops import groupnorm as jgn
from gdn_tpu_torch.config import kitti_config, nyu_config
from gdn_tpu_torch.kernels import groupnorm as gnk
from gdn_tpu_torch.ops.groupnorm import pick_groups
from gdn_tpu_torch.parallel.mesh import Axis
from gdn_tpu_torch.parallel.spatial import row_sizes

SMS = 132
RESIDENT = (4 * SMS, 8 * SMS)  # the H100 holds 4 or 8 blocks of 256 threads an SM
ALONE = Axis(None, 1, 0)
EPS = 1e-6
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=0.05, atol=0.05)}  # tests/test_torch_groupnorm.py's
# (C, h, W) of a spatial rank's half of every GN site of the KITTI net at
# 128x416, and how many of the 21 sites each is
KITTI_HALF = [(512, 2, 13, 2), (256, 4, 26, 4), (128, 8, 52, 4), (64, 16, 104, 4),
              (32, 32, 208, 4), (16, 64, 416, 2), (32, 64, 416, 1)]


_jax_gn = jax.jit(jgn._gn_elu_impl, static_argnums=(3, 4))  # one compile a shape


def _nyu_sites():
    m = nyu_config().model
    return sorted({(c, h, w, pick_groups(c, m.group_norm_groups))
                   for c, h, w in chip_smoke.gn_sites(m)}, reverse=True)


# ------------------------------------------------------------------ the plan

def _check_plan(b, hw, c, vec, resident):
    plan = gnk.rows_plan(b, hw, c, vec, resident)
    spi, rows = plan.slabs_per_image, plan.rows
    assert (spi - 1) * rows < hw <= spi * rows  # every row in one slab
    assert 1 <= plan.grid <= min(resident, b * spi)
    walks = [len(range(i, b * spi, plan.grid)) for i in range(plan.grid)]
    assert sum(walks) == b * spi and max(walks) == plan.slabs_per_block and min(walks) >= 1
    trip = gnk.ROWS_UNROLL * gnk.block_shape(c, vec)[1]
    assert plan.grid == min(resident, b * spi)
    if b * -(-hw // trip) <= resident:  # one trip a slab, as few slabs as that allows
        assert rows <= trip and spi == -(-hw // trip)
    else:  # as many slabs as the resident grid has, but for rounding rows to slabs
        most = b * max(1, resident // b)
        assert most >= b * spi >= 0.75 * most
    return plan


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("item", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("site", KITTI_HALF, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_rows_plan_covers_every_row_once_at_the_sites(site, item, resident):
    c, h, w, _ = site
    vec = 16 // item
    plan = _check_plan(32, h * w, c, vec, resident)
    if item == 2 and h * w <= 8 * 52:  # the three smallest in bf16: a few blocks an image
        assert plan.slabs_per_image <= 7  # (the earlier plan dealt them 13, 15 and 17)
    if (h, w) == (64, 416):  # the largest: one slab a block, every block resident
        assert plan.grid > resident - 32 and plan.slabs_per_block == 1


def test_rows_plan_holds_at_random_shapes():
    rng = np.random.default_rng(21)
    for _ in range(300):
        c = int(rng.choice([8, 16, 24, 48, 64, 512, 1024]))
        vec = int(rng.choice([1, 4, 8]))
        if c % vec:
            vec = 1
        b, hw = int(rng.integers(1, 70)), int(rng.integers(1, 60000))
        _check_plan(b, hw, c, vec, int(rng.choice([1, 3, 132, 528, 1056])))


def test_rows_plan_refuses_an_empty_card():
    with pytest.raises(ValueError, match="no block"):
        gnk.rows_plan(2, 10, 64, 8, 0)


def _sums_rows(nr, by):
    """The rows thread row ty of gn_rows_sums reads, trip after trip."""
    step = gnk.ROWS_UNROLL * by
    return [[r0 + u * by for u in range(gnk.ROWS_UNROLL) if r0 + u * by < nr]
            for ty in range(by) for r0 in range(ty, nr, step)]


def _apply_rows(nr, by):
    """The rows thread row ty of gn_rows_apply writes: chunks from the last."""
    chunk = gnk.ROWS_UNROLL * by
    out = []
    for ty in range(by):
        r0 = (nr - 1) // chunk * chunk + ty
        while r0 >= 0:
            out.append([r0 + u * by for u in range(gnk.ROWS_UNROLL) if r0 + u * by < nr])
            r0 -= chunk
    return out


@pytest.mark.parametrize("nr", [1, 3, 7, 16, 60, 128, 807, 1664])
@pytest.mark.parametrize("by", [1, 2, 4, 64, 128])
def test_unrolled_row_loops_touch_every_row_once(nr, by):
    for trips in (_sums_rows(nr, by), _apply_rows(nr, by)):
        rows = sorted(r for trip in trips for r in trip)
        assert rows == list(range(nr))
    # the apply walks a thread's chunks from the slab's end
    first = _apply_rows(nr, by)[0]
    assert first[0] == (nr - 1) // (gnk.ROWS_UNROLL * by) * gnk.ROWS_UNROLL * by


# -------------------------------------------------------------- the dataflow

def _rank_sums(x, groups, plan, order):
    """gn_rows_sums on one rank's NHWC rows x (B, hw, C): the slab
    partials, the image's fold in slab order by the block that takes its
    last ticket, blocks finishing in ``order`` -> (B, G, 2) fp32."""
    b, hw, c = x.shape
    spi, rows, cg = plan.slabs_per_image, plan.rows, c // groups
    xf = x.float()
    parts = torch.empty(b * spi, groups, 2)
    tickets, sums = [0] * b, torch.full((b, groups, 2), float("nan"))
    for s in order:
        slab = xf[s // spi, (s % spi) * rows:(s % spi + 1) * rows]
        parts[s, :, 0] = slab.sum(0).view(groups, cg).sum(-1)
        parts[s, :, 1] = (slab * slab).sum(0).view(groups, cg).sum(-1)
        tickets[s // spi] += 1
        if tickets[s // spi] == spi:  # the last ticket: fold in slab order
            img = parts[s // spi * spi:(s // spi + 1) * spi]
            acc = torch.zeros(groups, 2)
            for j in range(spi):
                acc = acc + img[j]
            sums[s // spi] = acc
    assert tickets == [spi] * b
    return sums


def _rank_apply(x, scale, bias, sums, groups, plan, n):
    """gn_rows_apply: each block's slabs in reverse -> (out, stats)."""
    b, hw, c = x.shape
    spi, rows, cg = plan.slabs_per_image, plan.rows, c // groups
    mean = sums[..., 0] / n
    inv = torch.rsqrt(torch.clamp(sums[..., 1] / n - mean * mean, min=0.0) + EPS)
    st = torch.stack([mean, inv], 1).repeat_interleave(cg, dim=2)  # (B, 2, C)
    out = torch.full_like(x, float("nan"))
    for blk in range(plan.grid):
        for s in reversed(range(blk, b * spi, plan.grid)):
            i, k = divmod(s, spi)
            sl = slice(k * rows, min((k + 1) * rows, hw))
            z = (x[i, sl].float() - st[i, 0]) * (st[i, 1] * scale) + bias
            out[i, sl] = torch.nn.functional.elu(z).to(x.dtype)
    return out, torch.stack([mean, inv], 1)


def _split_dataflow(x, scale, bias, groups, shards, resident=RESIDENT[1], seed=0):
    """The split form over ranks holding ``shards`` rows of NCHW x each:
    (out (B, C, H, W) reassembled, stats)."""
    b, c, h, w = x.shape
    vec = 16 // x.element_size()
    n = h * w * (c // groups)
    rng = np.random.default_rng(seed)
    parts, total = [], torch.zeros(b, groups, 2)
    for xr in torch.split(x, shards, dim=2):
        xr = xr.permute(0, 2, 3, 1).reshape(b, -1, c)
        plan = gnk.rows_plan(b, xr.shape[1], c, vec, resident) if xr.shape[1] else None
        if plan is not None:  # a rank without rows adds zeros
            total = total + _rank_sums(xr, groups, plan, rng.permutation(
                b * plan.slabs_per_image))
        parts.append((xr, plan))
    outs = []
    for xr, plan in parts:  # every rank reads the all-reduced sums
        if plan is None:
            outs.append(xr)
            continue
        out, stats = _rank_apply(xr, scale, bias, total, groups, plan, n)
        outs.append(out)
    mean = total[..., 0] / n
    stats = torch.stack([mean, torch.rsqrt(torch.clamp(total[..., 1] / n - mean * mean,
                                                       min=0.0) + EPS)], 1)
    out = torch.cat([o.reshape(b, -1, w, c) for o in outs], 1).permute(0, 3, 1, 2)
    return out, stats


def _inputs(b, c, h, w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 1).astype(np.float32)
    return (x, rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32))


def _check(x_np, scale, bias, groups, shards, dtype):
    b, h, w, c = x_np.shape
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2).to(dtype)
    st, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    got, stats = _split_dataflow(x, st, bi, groups, shards)
    want, want_stats = gnk._rows_plain(x, st, bi, groups, EPS, ALONE, h)
    assert got.dtype == dtype and not got.isnan().any()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **TOL[dtype])
    torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-6)
    # the JAX package's fp32 inverse std and the groups' mean of the same
    # rounded inputs
    xj = jnp.asarray(x_np).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    _, _, inv_c = _jax_gn(xj, jnp.asarray(scale), jnp.asarray(bias), groups, EPS)
    cg = c // groups
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(inv_c)[:, ::cg],
                               rtol=1e-5, atol=1e-6)
    xr = np.asarray(xj.astype(jnp.float32), np.float64).reshape(b, h * w, groups, cg)
    np.testing.assert_allclose(stats[:, 0].numpy(), xr.mean(axis=(1, 3)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", KITTI_HALF, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}")
def test_dataflow_matches_plain_and_jax_statistics_at_the_sites(site, dtype):
    """One rank holding a spatial rank's rows of each KITTI site (B=2; the
    plan at B=2 on the H100's resident grid)."""
    c, h, w, _ = site
    groups = pick_groups(c, kitti_config().model.group_norm_groups)
    x, scale, bias = _inputs(2, c, h, w, seed=c + h)
    _check(x, scale, bias, groups, [h], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dataflow_on_nyu_uneven_shards(dtype):
    """NYU's 228x304 net over two ranks: every site's rows split by
    ``tensor_split`` (57 -> 29 / 28, 15 -> 8 / 7, ...), B=1, channels cut
    to a quarter (the plan and the shards keep the site's rows)."""
    for c, h, w, g in _nyu_sites():
        c4 = max(c // 4, g)
        x, scale, bias = _inputs(1, c4, h, w, seed=h)
        _check(x, scale, bias, g, row_sizes(h, 2), dtype)


def test_dataflow_where_a_rank_holds_no_row():
    """An image of 1 row over two ranks: the second holds none, adds zero
    sums and launches nothing; the statistics are the first rank's."""
    x, scale, bias = _inputs(2, 32, 1, 7, seed=5)
    assert row_sizes(1, 2) == [1, 0]
    _check(x, scale, bias, 8, [1, 0], torch.float32)
    # the wrapper's own no-row path: no kernel, the statistics of zero sums
    empty = torch.empty(2, 32, 0, 7).contiguous(memory_format=torch.channels_last)
    before = gnk.group_norm_elu_rows.launches
    out, stats = gnk._launch_rows(empty, torch.ones(32), torch.zeros(32), 8, EPS, ALONE, 1)
    assert gnk.group_norm_elu_rows.launches == before and out.shape == empty.shape
    torch.testing.assert_close(stats[:, 0], torch.zeros(2, 8))
    torch.testing.assert_close(stats[:, 1], torch.full((2, 8), EPS ** -0.5))


def test_fold_is_the_same_whichever_block_takes_the_last_ticket():
    x = torch.randn(3, 900, 64) * 3 + 1
    plan = gnk.rows_plan(3, 900, 64, 4, 40)
    assert plan.slabs_per_image > 4
    runs = [_rank_sums(x, 8, plan, np.random.default_rng(s).permutation(
        3 * plan.slabs_per_image)) for s in range(4)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
