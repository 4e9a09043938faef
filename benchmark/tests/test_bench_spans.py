"""The readers of the program's own span samples (``harness/spans.py``,
``metrics/host_*.py``): nothing outside their kind, nothing when the
table is short of the window's units or the program keeps none, and the
median of the untraced samples otherwise."""

import sys
import types

import pytest

from harness import core, spans

TRAIN = {"kind": "train", "window_units": 3}
# 2 calls of 8 frames in batches of 3: 6 batches
BULK = {"kind": "bulk", "window_units": 16, "slice_units": 8, "batch": 3}
READERS = [("host_step_ms.train", "gdn.train.step", TRAIN, 3),
           ("host_backward_ms.train", "gdn.train.backward", TRAIN, 3),
           ("host_stage_ms.bulk", "gdn.predict.stage", BULK, 6),
           ("host_launch_ms.bulk", "gdn.predict.launch", BULK, 6),
           ("host_join_ms.bulk", "gdn.predict.join", BULK, 2)]


@pytest.fixture
def table():
    from gdn_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def test_bulk_units():
    assert spans.bulk_units(BULK) == (2, 6)
    assert spans.bulk_units({**BULK, "batch": 8}) == (2, 2)


@pytest.mark.parametrize("metric,name,ctx,units", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_the_median_of_enough_samples(table, metric, name, ctx, units):
    read = core.load_module("metrics", metric).read
    other = {**ctx, "kind": "bulk" if ctx["kind"] == "train" else "train"}
    for i in range(units - 1):
        table.TABLE.add(name, (i + 1) * 1_000_000)  # 1, 2, ... ms
    assert read(ctx) is None  # one short of the window's units
    table.TABLE.add(name, 100 * 1_000_000)
    durs = sorted([(i + 1) for i in range(units - 1)] + [100])
    mid = units // 2
    want = durs[mid] if units % 2 else (durs[mid - 1] + durs[mid]) / 2
    assert read(ctx) == pytest.approx(want)
    assert read(other) is None and read({"kind": "none"}) is None


def test_nothing_from_a_program_without_the_table(table, monkeypatch):
    import gdn_tpu_torch.utils

    table.TABLE.add("gdn.train.step", 5_000_000)
    assert spans.median_ms("gdn.train.step", 1) == pytest.approx(5.0)
    monkeypatch.setattr(gdn_tpu_torch.utils, "profiling", types.ModuleType("profiling"))
    monkeypatch.setitem(sys.modules, "gdn_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert spans.median_ms("gdn.train.step", 1) is None
