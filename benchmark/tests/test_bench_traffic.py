"""The inputs and traffic the benchmark makes from a seed."""

import numpy as np
import pytest
import torch

from harness import arrivals, inputs
from reference.model import param_shapes

SEED = 2 ** 31 + 17  # seeds run past 32 signed bits


def test_train_batches_are_a_function_of_seed_and_index():
    cpu = torch.device("cpu")
    a = inputs.train_batch(SEED, 4, 2, 16, 24, 80.0, cpu)
    b = inputs.train_batch(SEED, 4, 2, 16, 24, 80.0, cpu)
    c = inputs.train_batch(SEED, 5, 2, 16, 24, 80.0, cpu)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["rgb"], c["rgb"])
    assert a["rgb"].shape == (2, 16, 24, 3) and a["depth"].shape == (2, 16, 24, 1)
    assert 0.5 <= float(a["depth"].min()) and float(a["depth"].max()) <= 80.0
    stream = inputs.train_batches(SEED, 2, 16, 24, 80.0, cpu)
    next(stream)
    assert torch.equal(next(stream)["mask"], inputs.train_batch(SEED, 1, 2, 16, 24, 80.0,
                                                                cpu)["mask"])


def test_frame_pool_and_weights_repeat():
    cpu = torch.device("cpu")
    p = inputs.frame_pool(SEED, 5, 12, 20, cpu, block=2)
    assert p.dtype == np.uint8 and p.shape == (5, 12, 20, 3)
    assert np.array_equal(p, inputs.frame_pool(SEED, 5, 12, 20, cpu, block=2))
    assert not np.array_equal(p, inputs.frame_pool(SEED + 1, 5, 12, 20, cpu, block=2))
    cfg = {"enc_channels": [8, 16], "dec_channels": [16, 8]}
    d, g = inputs.make_nets_params(cfg, SEED, cpu)
    d2, g2 = inputs.make_nets_params(cfg, SEED, cpu)
    assert set(g) == set(param_shapes(cfg, 3)) and all(torch.equal(g[k], g2[k]) for k in g)
    assert all(torch.equal(g[k], d[k]) for k in g if k.startswith("decoder."))
    assert not torch.equal(g["encoder.down0.ConvBlock_0.Conv_0.kernel"],
                           d["encoder.down0.ConvBlock_0.Conv_0.kernel"])


@pytest.mark.parametrize("rate,seconds", [(1000.0, 20.0), (37.5, 8.0), (1500.0, 3.0)])
def test_arrivals_mean_rate_and_fixed_work(rate, seconds):
    due = arrivals.mmpp2(SEED, rate, seconds)
    assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] < seconds
    assert len(due) / seconds == pytest.approx(rate, rel=0.02)
    other = arrivals.mmpp2(SEED + 1, rate, seconds)
    assert abs(len(other) - len(due)) <= 2  # the same work, in another order
    assert not np.array_equal(other[:50], due[:50])
    assert np.array_equal(due, arrivals.mmpp2(SEED, rate, seconds))


def test_arrivals_burst_at_twice_the_calm_rate():
    due = arrivals.mmpp2(3, 1000.0, 40.0)
    counts = np.histogram(due, bins=np.arange(0.0, 40.0, 0.05))[0] / 0.05
    calm = 1000.0 * 1.25 / 1.5
    assert np.median(counts) == pytest.approx(calm, rel=0.15)
    assert np.percentile(counts, 97) > 1.6 * calm
