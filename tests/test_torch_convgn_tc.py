"""The tensor-core route of the port's fused conv3x3+GroupNorm+ELU.

Every entry point with bf16 taps runs on the tensor cores on the card:
``fused_conv_gn_elu``, ``fused_conv_gn_elu_bt``, ``fused_conv_gn_elu_s2``
and the two-input ``fused_fusion_bt`` and ``fused_fusion_block`` launch
``conv3x3_stats_tc``, ``fused_upsample_conv`` launches
``conv3x3_stats_tc_up`` (``gdn_tpu_torch/csrc/conv_gn_elu.cu``).  What
surrounds those kernels is Python and is held here on the CPU: the bf16
K-major weight packs (one source or two; the upsample's channel chunk
outer, tap inner), the tile choices (``tc_tile``, ``up_tile``) and the
partials they imply, and which entry point and tap dtype take which K
loop.  The kernels' dataflow (im2col in the kernel's K order against the
packed weights, at stride 1 or 2 with XLA's SAME pads, or of the
upsampled map U blended as the kernel blends it and rounded to bf16;
per-tile channel sums at the kernel's tiles, the per-group fold) is
written out below in plain PyTorch and held, like the entry points' CPU
path, against the JAX package's Pallas kernels in interpret mode with
bf16 taps on fp32 inputs: bf16 products are exact in fp32 on both sides
and only the order of the sums differs, so the JAX suite's forward
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
from gdn_tpu.kernels import upsample as jup
from gdn_tpu_torch.kernels import conv_gn_elu as tk
from gdn_tpu_torch.kernels import fusion_block as tb
from gdn_tpu_torch.kernels import fusion_bt as tf
from gdn_tpu_torch.kernels import upsample as tu
from gdn_tpu_torch.ops.conv import same_pads
from test_torch_convgn import S2_SHAPES
from test_torch_fusion import UP_SHAPES

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
# (Cin, Cout, H, W) of the input of the five stride-2 sites (128x416,
# enc 32...512) and of the five UpBlock up-convs (dec 256...16, to 2H x 2W)
S2_SITES = [(32, 32, 128, 416), (32, 64, 64, 208), (64, 128, 32, 104), (128, 256, 16, 52),
            (256, 512, 8, 26)]
UP_SITES = [(512, 256, 4, 13), (256, 128, 8, 26), (128, 64, 16, 52), (64, 32, 32, 104),
            (32, 16, 64, 208)]
S2_MAIN = [(b, *site) for b in (8, 32) for site in S2_SITES]
UP_MAIN = [(b, *site) for b in (8, 32) for site in UP_SITES]


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


def _blend_up(x):
    """U = the exact-2x bilinear upsample of NCHW x as the upsample kernel
    blends it: U row u takes x row u // 2 (near) and its far neighbour,
    the row before at an even u and after at an odd one, clamped into x;
    0.25 far + 0.75 near in fp32, each product and the sum rounded on its
    own, rows first and then columns."""
    def axis(n):
        near = torch.arange(2 * n) // 2
        far = torch.where(torch.arange(2 * n) % 2 == 1, (near + 1).clamp(max=n - 1),
                          (near - 1).clamp(min=0))
        return near, far

    (rn, rf), (cn, cf) = axis(x.shape[2]), axis(x.shape[3])
    v = 0.25 * x[:, :, rf] + 0.75 * x[:, :, rn]
    return 0.25 * v[..., cf] + 0.75 * v[..., cn]


def _tc_dataflow(x, w, scale, bias, groups, eps, lat=None, wl=None, stride=1,
                 upsample=False):
    """The tensor-core kernels' arithmetic in plain PyTorch, x (and lat)
    NCHW fp32 -> (a, yn, inv) NHWC-ordered fp32: im2col rows of
    bf16-rounded inputs times the packed weights, then per-tile (sum, sum
    of squares) in the (B, mtiles, Cout, 2) layout of the partials,
    folded per group, then normalize, affine, ELU.  Stride 1 or 2
    (conv3x3_stats_tc): K in (tap, x's channels, the lateral's channels)
    order, each source padded to a multiple of 8, XLA's SAME pads, tiles
    of tc_tile's BM consecutive output pixels.  ``upsample``
    (conv3x3_stats_tc_up): the im2col of U (``_blend_up``, rounded to
    bf16) with K in (chunk of 32 channels, tap, channel) order, tiles of
    up_tile's BM / 16 rows x 16 columns of U, row-major."""
    b, cin, h, w_ = x.shape
    cout = w.shape[0]
    if upsample:
        ho, wo = 2 * h, 2 * w_
        wk = tk.pack_weight_up(w).float()
        cin_p = wk.shape[1] // 9
        up = _blend_up(x.float()).to(torch.bfloat16).float().permute(0, 2, 3, 1)
        up = F.pad(up, (0, cin_p - cin, 1, 1, 1, 1)).view(b, ho + 2, wo + 2, -1, 32)
        cols = torch.stack([up[:, ky:ky + ho, kx:kx + wo] for ky in range(3)
                            for kx in range(3)], dim=4)  # (b, ho, wo, chunk, tap, 32)
        cols = cols.reshape(b, ho * wo, 9 * cin_p)
    else:
        ho, wo = -(-h // stride), -(-w_ // stride)
        (pt, pb), (pl, pr) = same_pads(h, 3, stride), same_pads(w_, 3, stride)
        wk = tk.pack_weight_tc(w, wl).float()
        kc_p = wk.shape[1] // 9
        srcs = [x] if lat is None else [x, lat]
        xp = torch.cat([F.pad(s.to(torch.bfloat16).float().permute(0, 2, 3, 1),
                              (0, tk.pad8(s.shape[1]) - s.shape[1], pl, pr, pt, pb))
                        for s in srcs], dim=3)
        assert xp.shape[3] == kc_p
        span_h, span_w = stride * (ho - 1) + 1, stride * (wo - 1) + 1
        cols = torch.stack([xp[:, ky:ky + span_h:stride, kx:kx + span_w:stride]
                            for ky in range(3) for kx in range(3)],
                           dim=3).reshape(b, ho * wo, 9 * kc_p)
    m = ho * wo
    y = cols @ wk.t()
    if upsample:
        bm, _ = tk.up_tile(b, ho, wo, cout)
        th, tw = bm // tk.UP_TW, tk.UP_TW
        ty, tx = -(-ho // th), -(-wo // tw)
        tiles = F.pad(y.view(b, ho, wo, cout), (0, 0, 0, tx * tw - wo, 0, ty * th - ho))
        tiles = tiles.view(b, ty, th, tx, tw, cout).permute(0, 1, 3, 2, 4, 5)
        tiles = tiles.reshape(b, ty * tx, bm, cout)
        assert ty * tx == tk.up_mtiles(ho, wo, bm)
    else:
        bm, _ = tk.tc_tile(b, m, wk.shape[1] // 9, cout)
        mtiles = -(-m // bm)
        tiles = F.pad(y, (0, 0, 0, mtiles * bm - m)).view(b, mtiles, bm, cout)
    partials = torch.stack([tiles.sum(2), (tiles * tiles).sum(2)], dim=-1)
    assert partials.shape == (b, tiles.shape[1], cout, 2)
    per_group = partials.view(b, -1, groups, cout // groups, 2).sum((1, 3))
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


@pytest.mark.parametrize("cin", [5, 32, 40, 64])
def test_pack_weight_up_layout_and_rounding(cin):
    """(Cout, 9 Cin_p) bf16, Cin_p = Cin rounded up to 32, column (chunk *
    9 + 3 ky + kx) * 32 + c holding channel chunk * 32 + c, zero past
    Cin; values rounded to nearest even."""
    cout = 6
    w = torch.randn(cout, cin, 3, 3, generator=torch.Generator().manual_seed(cin))
    wk = tk.pack_weight_up(w)
    cin_p = -(-cin // 32) * 32
    assert wk.shape == (cout, 9 * cin_p) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous()
    want = w.to(torch.bfloat16)
    for chunk in range(cin_p // 32):
        n = min(32, cin - 32 * chunk)
        for ky in range(3):
            for kx in range(3):
                col = (chunk * 9 + 3 * ky + kx) * 32
                assert torch.equal(wk[:, col:col + n],
                                   want[:, 32 * chunk:32 * chunk + n, ky, kx])
                assert not wk[:, col + n:col + 32].any()
    w = torch.zeros(1, 8, 3, 3)
    w[0, 0, 0, 0] = 1.0 + 2.0 ** -8
    assert tk.pack_weight_up(w)[0, 0].item() == 1.0


def test_pack_weight_up_k_order_is_the_convolution():
    """im2col of a map in (chunk of 32 channels, tap, channel) order times
    the pack is the SAME conv of the bf16-rounded operands (Cin 40: two
    chunks, the second padded with zeros)."""
    gen = torch.Generator().manual_seed(8)
    u = torch.randn(2, 40, 6, 7, generator=gen)
    w = torch.randn(10, 40, 3, 3, generator=gen)
    bf = lambda t: t.to(torch.bfloat16).float()
    want = F.conv2d(bf(u), bf(w), padding=1)
    up = F.pad(bf(u).permute(0, 2, 3, 1), (0, 24, 1, 1, 1, 1)).view(2, 8, 9, 2, 32)
    cols = torch.stack([up[:, ky:ky + 6, kx:kx + 7] for ky in range(3) for kx in range(3)],
                       dim=4).reshape(2, 42, 9 * 64)
    got = (cols @ tk.pack_weight_up(w).float().t()).view(2, 6, 7, 10).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_blend_up_is_the_plain_upsample_bit_for_bit():
    """The dataflow's U (the kernel's index-wise blend) is the plain
    version's shifted blends, bit for bit, H = 1 and W = 1 included."""
    from gdn_tpu_torch.ops.resize import upsample2x_bilinear

    gen = torch.Generator().manual_seed(9)
    for shape in [(2, 3, 4, 13), (1, 2, 1, 6), (1, 2, 5, 1)]:
        x = torch.randn(shape, generator=gen)
        assert torch.equal(_blend_up(x), upsample2x_bilinear(x))


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


@pytest.mark.parametrize("b,h,w,cin,cout,groups,t", S2_SHAPES)
def test_tc_dataflow_and_s2_entry_match_jax_bf16_taps(b, h, w, cin, cout, groups, t):
    """fp32 inputs, bf16 taps, stride 2 with XLA's SAME pads: the dataflow
    and the s2 entry point's CPU path against the JAX kernel's residuals."""
    arrays = _data(25, b, h, w, cin, cout)
    want = jk._conv_gn_elu_s2_all(*map(jnp.asarray, arrays), groups, EPS, t, True,
                                  "bfloat16")
    flow = _tc_dataflow(*_port(*arrays), groups, EPS, stride=2)
    entry = tk._conv_gn_elu_s2_all(*_port(*arrays), groups, EPS, "bfloat16")
    for name, j, d, e in zip(("a", "yn", "inv"), want, flow, entry):
        j = np.asarray(j)
        np.testing.assert_allclose(d.reshape(j.shape).numpy(), j, err_msg=name, **FWD)
        e = e.permute(0, 2, 3, 1) if e.dim() == 4 else e
        np.testing.assert_allclose(e.detach().numpy(), j, err_msg=name, **FWD)


@pytest.mark.parametrize("b,h,w", [(2, 7, 5), (1, 9, 12), (2, 1, 1)])
def test_tc_dataflow_s2_at_odd_and_even_sizes(b, h, w):
    """Pads (1, 1) at an odd length and (0, 1) at an even one: the
    dataflow's stride-2 im2col against the plain version (conv_same,
    cuDNN's route) with bf16 taps; Cin 5 pads to 8 as on the card."""
    x, k, s, bi = _port(*_data(26, b, h, w, 5, 8))
    flow = _tc_dataflow(x, k, s, bi, 4, EPS, stride=2)
    want = tk.conv_gn_elu_plain(x, k, s, bi, 4, EPS, 2, "bfloat16", torch.float32)
    for name, d, p in zip(("a", "yn", "inv"), flow, want):
        p = p.permute(0, 2, 3, 1).reshape(d.shape) if p.dim() == 4 else p
        torch.testing.assert_close(d, p, msg=name, **FWD)


@pytest.mark.parametrize("b,h,w,cin,cout,groups", UP_SHAPES)
def test_tc_dataflow_and_upsample_entry_match_jax_bf16_taps(b, h, w, cin, cout, groups):
    """fp32 inputs, bf16 taps: U blended as the kernel blends it, rounded
    to bf16, in the upsample kernel's K order and 2-D tiles, and the
    upsample entry point's CPU path, against the JAX kernel."""
    arrays = _data(27, b, h, w, cin, cout)
    want = np.asarray(jup.fused_upsample_conv(*map(jnp.asarray, arrays), groups, EPS, True,
                                              "bfloat16"))
    a, _, _ = _tc_dataflow(*_port(*arrays), groups, EPS, upsample=True)
    np.testing.assert_allclose(a.reshape(want.shape).numpy(), want, **FWD)
    got = tu.fused_upsample_conv(*_port(*arrays), groups, EPS, "bfloat16")
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


@pytest.mark.parametrize("b,cin,cout,h,w", S2_MAIN)
def test_tc_tile_fills_the_card_at_the_s2_sites(b, cin, cout, h, w):
    _tile_fills_the_card(b, -(-h // 2) * -(-w // 2), cin, cout)


@pytest.mark.parametrize("bm,bn", tk.TC_TILES)
def test_up_tiles_divide_as_the_kernel_expects(bm, bn):
    """conv3x3_stats_tc_up's tiles: BM / 16 rows of U, an even count (the
    x patch covers rows in pairs); whole mma tiles per warp; the weight
    copies (4 pieces a row of 32 channels) cover BN; the ring of four
    stages, the halo tile (rows of 64 + 16 bytes) and the fp32 x patch
    of two blocks fit an SM."""
    warps_m, warps_n = _warps(bn)
    threads = 32 * warps_m * warps_n
    th = bm // tk.UP_TW
    assert bm % tk.UP_TW == 0 and th % 2 == 0
    assert (bm // warps_m) % 16 == 0 and (bn // warps_n) % 16 == 0
    rows = threads // 4
    assert bn % rows == 0 or bn < rows
    smem = (4 * bn * 32 * 2 + (th + 2) * (tk.UP_TW + 2) * 80
            + (th // 2 + 2) * (tk.UP_TW // 2 + 2) * 32 * 4)
    assert 2 * smem <= 227 * 1024


@pytest.mark.parametrize("b,cin,cout,h,w", UP_MAIN)
def test_up_tile_fills_the_card_at_the_upsample_sites(b, cin, cout, h, w):
    """At the UpBlock sites (U = 2H x 2W): the tile is one of those BN
    suits, pads U at most 10% over the tightest 2-D tiling, fills a wave
    (or has the most blocks), and no larger tile that pads as little
    would still fill one; the U tiles cover the map exactly once."""
    ho, wo = 2 * h, 2 * w
    bm, bn = tk.up_tile(b, ho, wo, cout)
    narrow = 16 if cout <= 16 else 32
    tiles = [t for t in tk.TC_TILES if narrow <= t[1] <= max(narrow, cout)]
    assert (bm, bn) in tiles

    def blocks(t):
        return b * tk.up_mtiles(ho, wo, t[0]) * -(-cout // t[1])

    def padded(t):
        return tk.up_mtiles(ho, wo, t[0]) * t[0] * -(-cout // t[1]) * t[1]

    tight = min(padded(t) for t in tiles)
    assert padded((bm, bn)) <= 1.1 * tight
    assert blocks((bm, bn)) >= min(tk.SMS, max(blocks(t) for t in tiles))
    for t in tiles:
        if t[0] * t[1] > bm * bn and padded(t) <= 1.1 * tight:
            assert blocks(t) < tk.SMS
    th = bm // tk.UP_TW
    assert tk.up_mtiles(ho, wo, bm) * bm >= ho * wo
    bm32, bn32 = tk.up_tile(b, ho, wo, cout, fp32_in=True)  # fp32 inputs: no spilling tile
    assert bm32 == 64 or bn32 <= 32
    assert (tk.up_mtiles(ho, wo, bm) // -(-wo // tk.UP_TW) - 1) * th < ho


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
    (tk.fused_conv_gn_elu_s2, "bfloat16", "tc"), (tk.fused_conv_gn_elu_s2, "float32", "fma"),
    (tf.fused_fusion_bt, "bfloat16", "tc"), (tf.fused_fusion_bt, "float32", "fma"),
    (tb.fused_fusion_block, "bfloat16", "tc"), (tb.fused_fusion_block, "float32", "fma"),
    (tu.fused_upsample_conv, "bfloat16", "tc"), (tu.fused_upsample_conv, "float32", "fma"),
])
def test_kernel_route(entry, tap, route):
    assert tk.kernel_route(entry, tap) == route


@pytest.mark.parametrize("case", ["stride", "lateral", "upsample", "taps", "unknown",
                                  "stride2_lateral"])
def test_tc_route_refuses_what_the_kernel_does_not_take(case):
    """Stride 3; a lateral with the upsample or at stride 2; the upsample
    or any entry with fp32 taps; an unknown route."""
    x, w, s, bi = _port(*_data(22, 1, 4, 6, 8, 8))
    kw = dict(lat=None, wl=None, stride=1, tap_dtype="bfloat16", upsample=False,
              route="tc")
    if case == "stride":
        kw["stride"] = 3
    elif case == "lateral":  # two inputs take it, but not with the upsample
        kw.update(lat=x, wl=w, upsample=True)
    elif case == "stride2_lateral":  # ... nor at stride 2
        kw.update(lat=x, wl=w, stride=2)
    elif case == "upsample":  # the upsample takes the tensor cores with bf16 taps only
        kw.update(upsample=True, tap_dtype="float32")
    elif case == "taps":
        kw["tap_dtype"] = "float32"
    else:
        kw["route"] = "wgmma"
    with pytest.raises(ValueError, match="tensor-core|unknown route"):
        tk._launch(tk.fused_conv_gn_elu_bt, x, kw["lat"], w, kw["wl"], s, bi, 4, EPS,
                   kw["stride"], kw["tap_dtype"], torch.float32, False, kw["upsample"],
                   kw["route"])
