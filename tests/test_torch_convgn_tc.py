"""The tensor-core route of the port's stride-1 fused conv3x3+GroupNorm+ELU.

``fused_conv_gn_elu``, ``fused_conv_gn_elu_bt`` and the two-input
``fused_fusion_bt`` and ``fused_fusion_block`` with bf16 taps launch
``conv3x3_stats_tc`` (``gdn_tpu_torch/csrc/conv_gn_elu.cu``) on the card.
What surrounds that kernel is Python and is held here on the CPU: the
bf16 K-major weight pack (one source or two), the tile choice
(``tc_tile``) and the partials it implies, and which entry point and tap
dtype take which K loop.  The kernel's dataflow (im2col in (tap, x's
channels, the lateral's channels) order against the packed weights,
per-tile channel sums at ``tc_tile``'s BM, the per-group fold) is written
out below in plain PyTorch and held, like the entry points' CPU path,
against the JAX package's Pallas kernels in interpret mode with bf16
taps on fp32 inputs: bf16 products are exact in fp32 on both sides and
only the order of the sums differs, so the JAX suite's forward
tolerance (rtol 1e-4 / atol 1e-5) holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gdn_tpu.kernels import conv_gn_elu as jk
from gdn_tpu.kernels import fusion_block as jfb
from gdn_tpu.kernels import fusion_bt as jf
from gdn_tpu_torch.kernels import conv_gn_elu as tk
from gdn_tpu_torch.kernels import fusion_block as tb
from gdn_tpu_torch.kernels import fusion_bt as tf
from gdn_tpu_torch.kernels import upsample as tu

EPS = 1e-6
FWD = dict(rtol=1e-4, atol=1e-5)

# (Cin = Cout, H, W) of the five stride-1 refine sites of a KITTI net
# (128x416, enc 32...512), run at B=8 in serving and B=32 in training.
SITES = [(32, 64, 208), (64, 32, 104), (128, 16, 52), (256, 8, 26), (512, 4, 13)]
MAIN = [(b, *site) for b in (8, 32) for site in SITES]
# (Cx, Cl, Cout, H, W) of the five FusionBlocks of a KITTI net (dec
# 256...16 over the skips), B=8 in serving and B=32 in training.
FUSION_SITES = [(256, 256, 256, 8, 26), (128, 128, 128, 16, 52), (64, 64, 64, 32, 104),
                (32, 32, 32, 64, 208), (16, 32, 16, 128, 416)]
FUSION_MAIN = [(b, *site) for b in (8, 32) for site in FUSION_SITES]


def _data(seed, b, h, w, cin, cout):
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


def _port(x, w, s, bi):
    """NHWC / HWIO numpy -> the port's channels_last NCHW and OIHW."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(s), torch.from_numpy(bi))


def _port_fb(x, lat, wx, wl, s, bi):
    """The two-input arrays on the port's layouts; the weight halves as
    the model hands them over, strided slices of one OIHW kernel."""
    k = torch.from_numpy(np.concatenate([wx, wl], axis=2)).permute(3, 2, 0, 1).contiguous()
    cx = x.shape[-1]
    return (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(lat).permute(0, 3, 1, 2),
            k[:, :cx], k[:, cx:], torch.from_numpy(s), torch.from_numpy(bi))


def _tc_dataflow(x, w, scale, bias, groups, eps, lat=None, wl=None):
    """The tensor-core kernel's arithmetic in plain PyTorch, x (and lat)
    NCHW fp32 -> (a, yn, inv) NHWC-ordered fp32: im2col rows of
    bf16-rounded inputs in (tap, x's channels, the lateral's channels)
    order, each source padded to a multiple of 8, times the packed
    weights; per-tile (sum, sum of squares) at tc_tile's BM in the
    (B, mtiles, Cout, 2) layout of the partials, folded per group, then
    normalize, affine, ELU."""
    b, _, h, w_ = x.shape
    cout, m = w.shape[0], h * w_
    wk = tk.pack_weight_tc(w, wl).float()
    kc_p = wk.shape[1] // 9
    srcs = [x] if lat is None else [x, lat]
    xp = torch.cat([F.pad(s.to(torch.bfloat16).float().permute(0, 2, 3, 1),
                          (0, tk.pad8(s.shape[1]) - s.shape[1], 1, 1, 1, 1)) for s in srcs],
                   dim=3)
    assert xp.shape[3] == kc_p
    cols = torch.stack([xp[:, ky:ky + h, kx:kx + w_] for ky in range(3) for kx in range(3)],
                       dim=3).reshape(b, m, 9 * kc_p)
    y = cols @ wk.t()
    bm, _ = tk.tc_tile(b, m, kc_p, cout)
    mtiles = -(-m // bm)
    tiles = F.pad(y, (0, 0, 0, mtiles * bm - m)).view(b, mtiles, bm, cout)
    partials = torch.stack([tiles.sum(2), (tiles * tiles).sum(2)], dim=-1)
    assert partials.shape == (b, mtiles, cout, 2)
    per_group = partials.view(b, mtiles, groups, cout // groups, 2).sum((1, 3))
    count = m * (cout // groups)
    mean = per_group[..., 0] / count
    inv = torch.rsqrt((per_group[..., 1] / count - mean * mean).clamp(min=0) + eps)
    mean_c = mean.repeat_interleave(cout // groups, 1)[:, None]
    inv_c = inv.repeat_interleave(cout // groups, 1)[:, None]
    yn = (y - mean_c) * inv_c
    a = F.elu(yn * scale + bias)
    return a, yn, inv_c[:, 0]


# --------------------------------------------------------- the weight pack

@pytest.mark.parametrize("cin", [5, 8, 24, 32])
def test_pack_weight_tc_layout_and_rounding(cin):
    """(Cout, 9 Cin_p) bf16, column (3 ky + kx) Cin_p + c, Cin_p = Cin
    rounded up to 8, pad columns zero, values rounded to nearest even."""
    cout = 6
    w = torch.randn(cout, cin, 3, 3, generator=torch.Generator().manual_seed(cin))
    wk = tk.pack_weight_tc(w)
    cin_p = -(-cin // 8) * 8
    assert wk.shape == (cout, 9 * cin_p) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous() and wk.data_ptr() % 16 == 0
    want = w.to(torch.bfloat16)
    for ky in range(3):
        for kx in range(3):
            col = (3 * ky + kx) * cin_p
            assert torch.equal(wk[:, col:col + cin], want[:, :, ky, kx])
            assert not wk[:, col + cin:col + cin_p].any()
    # one value halfway between two bf16 neighbours rounds to the even one
    w = torch.zeros(1, 8, 3, 3)
    w[0, 0, 0, 0] = 1.0 + 2.0 ** -8
    assert tk.pack_weight_tc(w)[0, 0].item() == 1.0


def test_pack_weight_tc_k_order_is_the_convolution():
    """im2col in (tap, channel) order times the pack is the SAME conv of
    the bf16-rounded operands (the FMA kernel's pack for comparison)."""
    x, w, _, _ = _port(*_data(7, 2, 5, 7, 12, 10))
    y = F.conv2d(x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(), padding=1)
    wk = tk.pack_weight_tc(w).float()  # Cin 12 -> Cin_p 16
    xp = F.pad(x.to(torch.bfloat16).float().permute(0, 2, 3, 1), (0, 4, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + 5, kx:kx + 7] for ky in range(3) for kx in range(3)],
                       dim=3).reshape(2, 35, 9 * 16)
    got = (cols @ wk.t()).view(2, 5, 7, 10).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, y, rtol=1e-5, atol=1e-5)
    fma = tk.pack_weight(w, torch.bfloat16)  # (9, Cin, Cout)
    assert torch.equal(fma.permute(2, 0, 1).reshape(10, 9, 12),
                       tk.pack_weight_tc(w).float().view(10, 9, 16)[:, :, :12])


@pytest.mark.parametrize("cx,cl", [(5, 8), (8, 20), (12, 16), (16, 32), (3, 6)])
def test_pack_weight_tc_two_sources_layout_and_rounding(cx, cl):
    """Two halves (strided slices of one OIHW kernel, as the model hands
    them over) -> (Cout, 9 (Cx_p + Cl_p)) bf16: per tap x's Cx_p columns,
    then the lateral's Cl_p, each zero past its channels; values rounded
    to nearest even.  im2col of [x | lat], each padded to 8, times the
    pack is conv(x, wx) + conv(lat, wl) of the bf16-rounded operands."""
    cout = 6
    gen = torch.Generator().manual_seed(cx * 100 + cl)
    k = torch.randn(cout, cx + cl, 3, 3, generator=gen)
    wx, wl = k[:, :cx], k[:, cx:]
    assert not wl.is_contiguous()
    wk = tk.pack_weight_tc(wx, wl)
    cx_p, cl_p = tk.pad8(cx), tk.pad8(cl)
    kc_p = cx_p + cl_p
    assert wk.shape == (cout, 9 * kc_p) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous() and wk.data_ptr() % 16 == 0
    for ky in range(3):
        for kx in range(3):
            col = (3 * ky + kx) * kc_p
            assert torch.equal(wk[:, col:col + cx], wx[:, :, ky, kx].to(torch.bfloat16))
            assert not wk[:, col + cx:col + cx_p].any()
            assert torch.equal(wk[:, col + cx_p:col + cx_p + cl],
                               wl[:, :, ky, kx].to(torch.bfloat16))
            assert not wk[:, col + cx_p + cl:col + kc_p].any()
    x = torch.randn(2, cx, 5, 7, generator=gen)
    lat = torch.randn(2, cl, 5, 7, generator=gen)
    bf = lambda t: t.to(torch.bfloat16).float()
    want = F.conv2d(bf(x), bf(wx), padding=1) + F.conv2d(bf(lat), bf(wl), padding=1)
    xp = torch.cat([F.pad(bf(t).permute(0, 2, 3, 1), (0, tk.pad8(t.shape[1]) - t.shape[1]))
                    for t in (x, lat)], dim=3)
    xp = F.pad(xp, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + 5, kx:kx + 7] for ky in range(3) for kx in range(3)],
                       dim=3).reshape(2, 35, 9 * kc_p)
    got = (cols @ wk.float().t()).view(2, 5, 7, cout).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # one value halfway between two bf16 neighbours rounds to the even one
    k = torch.zeros(1, 16, 3, 3)
    k[0, 8, 0, 0] = 1.0 + 2.0 ** -8
    assert tk.pack_weight_tc(k[:, :8], k[:, 8:])[0, 8].item() == 1.0


# ------------------------------------------------- the kernel's dataflow vs JAX

@pytest.mark.parametrize("b,h,w,cin,cout,groups,t", [
    (4, 8, 16, 32, 32, 8, 2), (2, 8, 16, 128, 128, 8, 2), (4, 5, 16, 16, 16, 4, 2),
])
def test_tc_dataflow_and_bt_entry_match_jax_bf16_taps(b, h, w, cin, cout, groups, t):
    """fp32 inputs, bf16 taps: the dataflow above and the bt entry
    point's CPU path against the JAX kernel's residuals."""
    arrays = _data(20, b, h, w, cin, cout)
    want = jk._conv_gn_elu_bt_all(*map(jnp.asarray, arrays), groups, EPS, t, True,
                                  "bfloat16")
    flow = _tc_dataflow(*_port(*arrays), groups, EPS)
    entry = tk._conv_gn_elu_bt_all(*_port(*arrays), groups, EPS, "bfloat16")
    for name, j, d, e in zip(("a", "yn", "inv"), want, flow, entry):
        j = np.asarray(j)
        np.testing.assert_allclose(d.reshape(j.shape).numpy(), j, err_msg=name, **FWD)
        e = e.permute(0, 2, 3, 1) if e.dim() == 4 else e
        np.testing.assert_allclose(e.detach().numpy(), j, err_msg=name, **FWD)


def test_tc_dataflow_matches_jax_per_image_kernel_bf16_taps():
    arrays = _data(21, 2, 10, 14, 16, 16)
    want = np.asarray(jk.fused_conv_gn_elu(*map(jnp.asarray, arrays), 4, EPS, True,
                                           "bfloat16"))
    a, _, _ = _tc_dataflow(*_port(*arrays), 4, EPS)
    np.testing.assert_allclose(a.reshape(want.shape).numpy(), want, **FWD)
    got = tk.fused_conv_gn_elu(*_port(*arrays), 4, EPS, "bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **FWD)


# (b, h, w, cx, cl, cout, groups, batch tile of the TPU kernel): the JAX
# kernel packs p pixels into 128 lanes (p Cx, p Cl, p Cout all multiples
# of 128, W % p == 0); Cout 16 takes the BN = 16 tile, Cx 12 the
# register path, Cx + Cl = 64 the 64-column K step
FB_BF16 = [(4, 8, 16, 32, 32, 32, 8, 2), (4, 8, 16, 16, 32, 16, 4, 2),
           (2, 4, 32, 12, 16, 8, 4, 2)]


@pytest.mark.parametrize("b,h,w,cx,cl,cout,groups,t", FB_BF16)
def test_tc_dataflow_and_fusion_bt_entry_match_jax_bf16_taps(b, h, w, cx, cl, cout, groups,
                                                             t):
    """fp32 inputs, bf16 taps, two sources: the dataflow above and the
    fusion_bt entry point's CPU path against the JAX kernel's residuals."""
    arrays = _fb_data(23, b, h, w, cx, cl, cout)
    want = jf._fusion_bt_all(*map(jnp.asarray, arrays), groups, EPS, t, True, "bfloat16")
    x, lat, wx, wl, s, bi = _port_fb(*arrays)
    flow = _tc_dataflow(x, wx, s, bi, groups, EPS, lat, wl)
    entry = tf._fusion_bt_all(x, lat, wx, wl, s, bi, groups, EPS, "bfloat16")
    for name, j, d, e in zip(("a", "yn", "inv"), want, flow, entry):
        j = np.asarray(j)
        np.testing.assert_allclose(d.reshape(j.shape).numpy(), j, err_msg=name, **FWD)
        e = e.permute(0, 2, 3, 1) if e.dim() == 4 else e
        np.testing.assert_allclose(e.detach().numpy(), j, err_msg=name, **FWD)


@pytest.mark.parametrize("b,h,w,cx,cl,cout,groups", [
    (2, 10, 14, 16, 8, 16, 4), (2, 9, 7, 12, 16, 24, 8), (2, 6, 5, 48, 20, 12, 4),
])
def test_tc_dataflow_matches_jax_fusion_block_bf16_taps(b, h, w, cx, cl, cout, groups):
    """The per-image two-input kernel (any channel counts: Cx 12 and Cl 20
    take the register path) against the dataflow and the entry point."""
    arrays = _fb_data(24, b, h, w, cx, cl, cout)
    want = np.asarray(jfb.fused_fusion_block(*map(jnp.asarray, arrays), groups, EPS, True,
                                             "bfloat16"))
    x, lat, wx, wl, s, bi = _port_fb(*arrays)
    a, _, _ = _tc_dataflow(x, wx, s, bi, groups, EPS, lat, wl)
    np.testing.assert_allclose(a.reshape(want.shape).numpy(), want, **FWD)
    got = tb.fused_fusion_block(x, lat, wx, wl, s, bi, groups, EPS, "bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **FWD)


# ------------------------------------------------------------- the tiles

def _warps(bn):
    """conv3x3_stats_tc's block: (warps along M, along N), WN = 32 output
    channels a warp (16 at BN <= 32), 4 warps along M at BN = 16."""
    return (4 if bn == 16 else 2), bn // (32 if bn >= 64 else 16)


@pytest.mark.parametrize("bm,bn", tk.TC_TILES)
@pytest.mark.parametrize("bk,stages", [(32, 4), (64, 3)])
def test_tc_tiles_divide_as_the_kernel_expects(bm, bn, bk, stages):
    """Every tile at the 32-column K step, the 64-row ones at the
    64-column step (Cx_p + Cl_p % 64 == 0), as the C side instantiates
    them."""
    if bk == 64 and bm != 64:
        assert all(tk.tc_tile(b, m, 64 * k, c)[0] == 64 for b in (1, 8, 32)
                   for m in (1, 52, 13312) for k in (1, 3, 8) for c in (6, 16, 64, 512))
        return
    warps_m, warps_n = _warps(bn)
    threads = 32 * warps_m * warps_n
    wn = bn // warps_n
    pieces = bk // 8  # 16-byte copies of a tile row
    rows = threads // pieces  # tile rows one pass of the block's copies covers
    assert bm % rows == 0 and (bn % rows == 0 or bn < rows)
    assert (bm // warps_m) % 16 == 0 and wn % 16 == 0 and bk % 16 == 0  # whole mma tiles
    assert threads >= bn and threads <= 1024
    assert 2 * stages * (bm + bn) * bk * 2 <= 227 * 1024  # two blocks' rings an SM


def _tile_fills_the_card(b, m, cin, cout):
    bm, bn = tk.tc_tile(b, m, cin, cout)
    narrow = 16 if cout <= 16 else 32
    tiles = [t for t in tk.TC_TILES if narrow <= t[1] <= max(narrow, cout)
             and (cin % 64 or t[0] == 64)]
    assert (bm, bn) in tiles

    def blocks(t):
        return b * -(-m // t[0]) * -(-cout // t[1])

    def padded(t):
        return -(-m // t[0]) * t[0] * -(-cout // t[1]) * t[1]

    most = max(blocks(t) for t in tiles)
    assert blocks((bm, bn)) >= min(tk.SMS, most) and blocks((bm, bn)) >= 128
    tight = min(padded(t) for t in tiles)
    assert padded((bm, bn)) <= 1.1 * tight  # little tensor-core work thrown away
    # no larger tile that pads as little would still fill one wave
    for t in tiles:
        if t[0] * t[1] > bm * bn and padded(t) <= 1.1 * tight:
            assert blocks(t) < tk.SMS
    # the normalize launch: two waves, at most 16384 elements a block
    rows = tk.apply_rows(b, m, cout)
    assert b * -(-m // rows) >= 2 * tk.SMS and rows * cout <= 16384


@pytest.mark.parametrize("b,cin,h,w", MAIN)
def test_tc_tile_fills_the_card_at_the_main_path_sites(b, cin, h, w):
    _tile_fills_the_card(b, h * w, cin, cin)


@pytest.mark.parametrize("b,cx,cl,cout,h,w", FUSION_MAIN)
def test_tc_tile_fills_the_card_at_the_fusion_sites(b, cx, cl, cout, h, w):
    _tile_fills_the_card(b, h * w, tk.pad8(cx) + tk.pad8(cl), cout)


def test_tc_tile_choices():
    """The deep site at B=8 gets 128 blocks (8 x 16) from the smallest
    tile, not 64; the shallow one the largest tile its 32 channels take;
    with Cin % 64 == 0 only 64-row tiles; where 128 rows are allowed they
    must not pad the map much (832 pixels: 7%, taken; 52 pixels: 2.5x,
    not taken)."""
    assert tk.tc_tile(8, 52, 512, 512) == (64, 32)
    assert tk.tc_tile(8, 13312, 32, 32) == (128, 32)
    assert tk.tc_tile(32, 832, 128, 128) == (64, 128)
    assert tk.tc_tile(32, 832, 96, 128) == (128, 128)
    assert tk.tc_tile(32, 52, 96, 512) == (64, 64)
    assert tk.tc_tile(32, 52, 512, 512) == (64, 64)
    assert tk.tc_tile(2, 35, 8, 6) == (64, 16)  # Cout < 16: the narrowest tile
    assert tk.tc_tile(32, 53248, 48, 16) == (128, 16)  # (16+32) -> 16 at 128x416
    assert tk.tc_tile(8, 53248, 48, 16) == (128, 16)
    assert tk.tc_tile(3, 99, 24, 40) == (64, 32)
    # the register path keeps 128 rows to BN <= 32 (wider ones spill)
    assert tk.tc_tile(32, 832, 96, 128, gather=True) == (64, 128)
    assert tk.tc_tile(32, 53248, 48, 16, gather=True) == (128, 16)
    assert all(t[0] == 64 or t[1] <= 32 for b in (1, 8, 32) for m in (52, 832, 13312)
               for c in (8, 24, 96) for cout in (6, 40, 128, 512)
               for t in [tk.tc_tile(b, m, c, cout, gather=True)])


# ------------------------------------------------------------- the route

@pytest.mark.parametrize("entry,tap,route", [
    (tk.fused_conv_gn_elu, "bfloat16", "tc"), (tk.fused_conv_gn_elu, "float32", "fma"),
    (tk.fused_conv_gn_elu_bt, "bfloat16", "tc"), (tk.fused_conv_gn_elu_bt, "float32", "fma"),
    (tk.fused_conv_gn_elu_s2, "bfloat16", "fma"), (tk.fused_conv_gn_elu_s2, "float32", "fma"),
    (tf.fused_fusion_bt, "bfloat16", "tc"), (tf.fused_fusion_bt, "float32", "fma"),
    (tb.fused_fusion_block, "bfloat16", "tc"), (tb.fused_fusion_block, "float32", "fma"),
    (tu.fused_upsample_conv, "bfloat16", "fma"), (tu.fused_upsample_conv, "float32", "fma"),
])
def test_kernel_route(entry, tap, route):
    assert tk.kernel_route(entry, tap) == route


@pytest.mark.parametrize("case", ["stride", "lateral", "upsample", "taps", "unknown"])
def test_tc_route_refuses_what_the_kernel_does_not_take(case):
    x, w, s, bi = _port(*_data(22, 1, 4, 6, 8, 8))
    kw = dict(lat=None, wl=None, stride=1, tap_dtype="bfloat16", upsample=False,
              route="tc")
    if case == "stride":
        kw["stride"] = 2
    elif case == "lateral":  # two inputs take it, but not with the upsample
        kw.update(lat=x, wl=w, upsample=True)
    elif case == "upsample":
        kw["upsample"] = True
    elif case == "taps":
        kw["tap_dtype"] = "float32"
    else:
        kw["route"] = "wgmma"
    with pytest.raises(ValueError, match="tensor-core|unknown route"):
        tk._launch(tk.fused_conv_gn_elu_bt, x, kw["lat"], w, kw["wl"], s, bi, 4, EPS,
                   kw["stride"], kw["tap_dtype"], torch.float32, False, kw["upsample"],
                   kw["route"])
