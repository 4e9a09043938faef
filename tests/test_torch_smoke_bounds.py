"""The work counts behind the bounds that ``chip_smoke.py`` reports for the
fused conv kernels (``conv_work``), the GroupNorm+ELU kernel (``gn_work``)
and its backward (``gn_bwd_work``) and the fused loss (``loss_work``), held
to hand arithmetic on the CPU.

A bound is the larger of the flops at the card's peak and the bytes at
its memory rate, so each count must hold every byte the function must
move once: the inputs, the fp32 weights, scale and bias, ``a`` and, where
the entry point stores residuals, ``yn`` (x's dtype) and the fp32
``inv``.  Nothing here needs a card: ``chip_smoke`` imports torch and
numpy only at the top.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_s2_site_counts_a_yn_and_inv():
    """The first stride-2 site at B=32, bf16: x 32 x 128 x 416 -> 32 x 64
    x 208."""
    flops, nbytes = chip_smoke.conv_work("conv_gn_elu_s2", (32, 32, 32, 128, 416), 2, True)
    assert flops == 7_851_737_088  # 18 * 32 * 32 * (64 * 208) * 32
    x = 32 * 128 * 416 * 32 * 2  # 109,051,904
    weights = 3 * 3 * 32 * 32 * 4 + 2 * 32 * 4  # kernel, scale and bias: 37,120
    a = 32 * 64 * 208 * 32 * 2  # 27,262,976 (and yn the same)
    inv = 32 * 32 * 4
    assert nbytes == x + weights + a + a + inv == 163_619_072
    # serving stores a alone
    assert chip_smoke.conv_work("conv_gn_elu_s2", (32, 32, 32, 128, 416), 2, False) == (
        flops, x + weights + a)


def test_fusion_bt_site_counts_both_inputs_and_yn():
    """The last FusionBlock site at B=32, bf16: x 16 and lateral 32
    channels at 128 x 416 -> 16."""
    flops, nbytes = chip_smoke.conv_work("fusion_bt", (32, 16, 32, 16, 128, 416), 2, True)
    assert flops == 23_555_211_264  # 18 * 48 * 16 * (128 * 416) * 32
    inputs = 32 * 128 * 416 * (16 + 32) * 2  # 163,577,856
    weights = 3 * 3 * 48 * 16 * 4 + 2 * 16 * 4  # 27,776
    a = 32 * 128 * 416 * 16 * 2  # 54,525,952 (and yn the same)
    assert nbytes == inputs + weights + 2 * a + 32 * 16 * 4 == 272_659_584


@pytest.mark.parametrize("name,shape,ho,wo", [
    ("upsample", (32, 32, 16, 64, 208), 128, 416),
    ("fusion_block", (8, 32, 32, 32, 64, 208), 64, 208),
    ("conv_gn_elu", (8, 512, 512, 4, 13), 4, 13),
])
def test_fp32_out_entry_points_count_fp32_a(name, shape, ho, wo):
    """The per-image, fusion-block and upsample entry points store fp32 a
    and no residuals, whatever x's dtype; the upsample's output map is
    2H x 2W."""
    b, *chans, h, w = shape
    cin, cout = sum(chans[:-1]), chans[-1]
    flops, nbytes = chip_smoke.conv_work(name, shape, 2, False)
    assert flops == 18 * cin * cout * ho * wo * b
    assert nbytes == b * h * w * cin * 2 + 9 * cin * cout * 4 + 2 * cout * 4 + (
        b * ho * wo * cout * 4)


def test_gn_work_at_the_largest_serving_site():
    """The 32-channel 128 x 416 GroupNorm+ELU site at B=8, bf16: 27.3 MB
    read and 27.3 MB written, 16.3 us at 3.35 TB/s."""
    flops, nbytes = chip_smoke.gn_work((8, 32, 128, 416), 2)
    x = 8 * 32 * 128 * 416 * 2  # 27,262,976
    assert nbytes == 2 * x + 2 * 32 * 4 == 54_526_208
    assert flops == 8 * 8 * 32 * 128 * 416  # GN_FLOPS_PER_ELEM a element
    assert chip_smoke.bound_ms(flops, nbytes) == pytest.approx(54_526_208 / 3.35e9)
    assert chip_smoke.bound_ms(flops, nbytes) == pytest.approx(0.0163, abs=5e-5)


@pytest.mark.parametrize("site", [(128, 32, 128, 416), (128, 16, 128, 416), (96, 32, 228, 304)])
def test_gn_bwd_work_at_the_training_sites(site):
    """The backward at the stage-2 cells' largest sites, bf16: x and da
    read once and dx written once, the fp32 scale and bias read and their
    gradients written; bytes bound it (22 operations an element)."""
    flops, nbytes = chip_smoke.gn_bwd_work(site, 2)
    b, c, h, w = site
    x = b * c * h * w * 2
    assert nbytes == 3 * x + 4 * c * 4
    assert flops == 22 * b * c * h * w  # GN_BWD_FLOPS_PER_ELEM an element
    assert chip_smoke.bound_ms(flops, nbytes) == pytest.approx(nbytes / 3.35e9)


def test_gn_bwd_bound_over_a_kitti_step():
    """The 21 sites of the KITTI G-net at B=128, bf16: 852 M elements,
    3 passes of bytes, 1.526 ms at 3.35 TB/s."""
    from gdn_tpu_torch.config import kitti_config

    sites = chip_smoke.gn_sites(kitti_config().model)
    numel = sum(128 * c * h * w for c, h, w in sites)
    assert numel == 851_968_000  # 6.656 M an image
    total = sum(chip_smoke.bound_ms(*chip_smoke.gn_bwd_work((128, c, h, w), 2))
                for c, h, w in sites)
    assert total == pytest.approx(3 * 2 * numel / 3.35e9, rel=1e-5)
    assert total == pytest.approx(1.526, abs=5e-4)


def test_loss_work_at_the_training_batch():
    """The fused loss at B=32, 128 x 416: 427 fp32 operations a pixel in
    the backward (10.86 us at 67 TFLOP/s) against 16 bytes (8.1 us), 261
    and 12 bytes in the forward."""
    work = chip_smoke.loss_work(32, 128, 416)
    px = 32 * 128 * 416  # 1,703,936
    assert work["bwd"] == (427 * px, 16 * px)
    assert work["fwd"] == (261 * px, 12 * px)
    assert chip_smoke.bound_ms(*work["bwd"]) == pytest.approx(427 * px / 67e9)
    assert chip_smoke.bound_ms(*work["bwd"]) == pytest.approx(0.01086, abs=5e-6)
    assert chip_smoke.bound_ms(*work["fwd"]) == pytest.approx(261 * px / 67e9)
