"""The yardstick's operation and byte counts against hand counts."""

import json
import os

import pytest

from harness.core import BENCH
from roofline import work


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_sites_of_a_kitti_g_net():
    sites = work.net_sites(_cfg("gdn-kitti"), 3)
    assert len(sites) == 22 and sum(s.gn for s in sites) == 21
    stem, s2 = sites[0], sites[1]
    assert (stem.cin, stem.cout, stem.k, stem.ho, stem.wo) == (3, 32, 7, 128, 416)
    assert (s2.cin, s2.cout, s2.ho, s2.wo) == (32, 32, 64, 208)
    fuse4 = next(s for s in sites if s.name == "up4.fuse")
    assert (fuse4.cin, fuse4.cout, fuse4.ho, fuse4.wo) == (16 + 32, 16, 128, 416)


def test_nyu_levels_round_up():
    assert work.level_sizes(228, 304, 5) == [(228, 304), (114, 152), (57, 76), (29, 38),
                                             (15, 19), (8, 10)]
    up0 = next(s for s in work.net_sites(_cfg("gdn-nyu"), 3) if s.name == "up0.up")
    assert (up0.cin, up0.cout, up0.ho, up0.wo) == (512, 256, 15, 19)


def test_one_site_by_hand():
    # the stem of a G-net at B=2: 2 * 7*7 * 3 * 32 * 128*416 * 2
    stem = work.net_sites(_cfg("gdn-kitti"), 3)[0]
    assert work.conv_flops(stem, 2) == 2 * 49 * 3 * 32 * 128 * 416 * 2
    # its GroupNorm+ELU in bf16: 8 a element, x read and out written, scale and bias
    numel = 2 * 32 * 128 * 416
    assert work.gn_work((2, 32, 128, 416), 2) == (8 * numel, 4 * numel + 256)
    assert work.bound_ms(0, 3.35e9) == pytest.approx(1.0)


def test_forward_and_step_counts():
    cfg = _cfg("gdn-kitti")
    g = work.forward_flops(cfg, 3, 1)
    assert g == pytest.approx(7.63e9, rel=2e-3)
    enc = sum(work.conv_flops(s, 1) for s in work.net_sites(cfg, 3) if s.part == "encoder")
    stem = work.conv_flops(work.net_sites(cfg, 3)[0], 1)
    dec = g - enc
    d = work.forward_flops(cfg, 1, 1)
    assert work.stage2_step_flops(cfg, 4) == pytest.approx(4 * (d + g + 2 * enc - stem + dec))


def test_loss_and_gn_bounds():
    cfg = _cfg("gdn-kitti")
    w = work.loss_work(2, 128, 416)
    px = 2 * 128 * 416
    assert w["fwd"] == (work.LOSS_FWD_FLOPS_PX * px, 12 * px)
    assert work.stage2_loss_bound_ms(cfg, 2) == pytest.approx(
        1e3 * (work.LOSS_FWD_FLOPS_PX + work.LOSS_BWD_FLOPS_PX) * px / work.FP32_FLOPS)
    one = sum(work.bound_ms(*work.gn_work((2, s.cout, s.ho, s.wo), 2))
              for s in work.net_sites(cfg, 3) if s.gn)
    assert work.stage2_gn_bound_ms(cfg, 2) == pytest.approx(2 * one, rel=1e-3)
