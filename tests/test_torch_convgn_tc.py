"""The tensor-core route of the port's stride-1 fused conv3x3+GroupNorm+ELU.

``fused_conv_gn_elu`` and ``fused_conv_gn_elu_bt`` with bf16 taps launch
``conv3x3_stats_tc`` (``gdn_tpu_torch/csrc/conv_gn_elu.cu``) on the card.
What surrounds that kernel is Python and is held here on the CPU: the
bf16 K-major weight pack, the tile choice (``tc_tile``) and the partials
it implies, and which entry point and tap dtype take which K loop.  The
kernel's dataflow (im2col in (tap, channel) order against the packed
weights, per-tile channel sums at ``tc_tile``'s BM, the per-group fold)
is written out below in plain PyTorch and held, like the entry points'
CPU path, against the JAX package's Pallas kernels in interpret mode
with bf16 taps on fp32 inputs: bf16 products are exact in fp32 on both
sides and only the order of the sums differs, so the JAX suite's
forward tolerance (rtol 1e-4 / atol 1e-5) holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gdn_tpu.kernels import conv_gn_elu as jk
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


def _data(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, cin)).astype(np.float32),
            rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, cout).astype(np.float32),
            rng.normal(size=cout).astype(np.float32) * 0.1)


def _port(x, w, s, bi):
    """NHWC / HWIO numpy -> the port's channels_last NCHW and OIHW."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(),
            torch.from_numpy(s), torch.from_numpy(bi))


def _tc_dataflow(x, w, scale, bias, groups, eps):
    """The tensor-core kernel's arithmetic in plain PyTorch, x NCHW fp32
    -> (a, yn, inv) NHWC-ordered fp32: im2col rows of bf16-rounded x in
    (tap, channel) order times the packed weights, per-tile (sum, sum of
    squares) at tc_tile's BM in the (B, mtiles, Cout, 2) layout of the
    partials, folded per group, then normalize, affine, ELU."""
    b, cin, h, w_ = x.shape
    cout, m = w.shape[0], h * w_
    wk = tk.pack_weight_tc(w).float()
    cin_p = wk.shape[1] // 9
    xp = F.pad(x.to(torch.bfloat16).float().permute(0, 2, 3, 1),
               (0, cin_p - cin, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + h, kx:kx + w_] for ky in range(3) for kx in range(3)],
                       dim=3).reshape(b, m, 9 * cin_p)
    y = cols @ wk.t()
    bm, _ = tk.tc_tile(b, m, cin, cout)
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


# ------------------------------------------------------------- the tiles

def _threads(bn):
    """conv3x3_stats_tc's block: 2 warps along M x BN / WN along N."""
    return 64 * (bn // (32 if bn >= 64 else 16))


@pytest.mark.parametrize("bm,bn", tk.TC_TILES)
@pytest.mark.parametrize("bk,stages", [(32, 4), (64, 3)])
def test_tc_tiles_divide_as_the_kernel_expects(bm, bn, bk, stages):
    """Every tile at the 32-channel K step, the 64-row ones at the
    64-channel step (Cin % 64 == 0), as the C side instantiates them."""
    if bk == 64 and bm != 64:
        assert all(tk.tc_tile(b, m, 64 * k, c)[0] == 64 for b in (1, 8, 32)
                   for m in (1, 52, 13312) for k in (1, 3, 8) for c in (6, 64, 512))
        return
    threads = _threads(bn)
    wn = 32 if bn >= 64 else 16
    pieces = bk // 8  # 16-byte copies of a tile row
    assert (bm * pieces) % threads == 0 and (bn * pieces) % threads == 0
    assert (bm // 2) % 16 == 0 and wn % 16 == 0 and bk % 16 == 0  # whole mma tiles
    assert threads >= bn and threads <= 1024
    assert 2 * stages * (bm + bn) * bk * 2 <= 227 * 1024  # two blocks' rings an SM


@pytest.mark.parametrize("b,cin,h,w", MAIN)
def test_tc_tile_fills_the_card_at_the_main_path_sites(b, cin, h, w):
    m, cout = h * w, cin
    bm, bn = tk.tc_tile(b, m, cin, cout)
    tiles = [t for t in tk.TC_TILES if t[1] <= cout and (cin % 64 or t[0] == 64)]
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
    assert tk.tc_tile(2, 35, 5, 6) == (64, 32)  # Cout < 32: the narrowest tile
    assert tk.tc_tile(3, 99, 24, 40) == (64, 32)


# ------------------------------------------------------------- the route

@pytest.mark.parametrize("entry,tap,route", [
    (tk.fused_conv_gn_elu, "bfloat16", "tc"), (tk.fused_conv_gn_elu, "float32", "fma"),
    (tk.fused_conv_gn_elu_bt, "bfloat16", "tc"), (tk.fused_conv_gn_elu_bt, "float32", "fma"),
    (tk.fused_conv_gn_elu_s2, "bfloat16", "fma"), (tk.fused_conv_gn_elu_s2, "float32", "fma"),
    (tf.fused_fusion_bt, "bfloat16", "fma"), (tb.fused_fusion_block, "bfloat16", "fma"),
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
    elif case == "lateral":
        kw.update(lat=x, wl=w)
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
