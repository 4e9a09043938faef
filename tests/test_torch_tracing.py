"""The port's spans (gdn_tpu_torch/utils/profiling.py) on the CPU, and
where the program places them.

- The table: count, sum and median, the ring's bound; exact counts
  under many threads, as the batcher's worker and its callers update it.
- Under a CPU ``torch.profiler`` a span is a ``user_annotation`` in the
  exported Chrome trace and adds nothing to the table; without one no
  ``record_function`` is entered.
- ``BatchedPredictor.predict``: ceil(N/b) ``stage`` and ``launch``
  samples and one ``join`` a call.
- ``_epoch_loop`` over k steps: k ``gdn.train.step``, ``.forward``,
  ``.backward`` and ``.update`` samples, one ``readback`` a logged line,
  and their means in the line.
- The batcher: ``/stats`` reports ``mean_queue_wait_ms`` (submit to the
  worker taking a request) and ``mean_flush_ms`` (the flush spans).
"""

import json
import math
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import init_params
from gdn_tpu_torch.utils import profiling as P

HW = (32, 64)


@pytest.fixture(autouse=True)
def _empty_table():
    P.reset()
    yield
    P.reset()


# ------------------------------------------------------------------ table

def test_span_records_count_sum_and_median():
    spans = []
    for _ in range(3):
        with P.span("s") as sp:
            pass
        spans.append(sp.ns)
    assert all(ns > 0 for ns in spans)
    st = P.stats("s")
    assert st["count"] == 3
    assert st["sum_ms"] == pytest.approx(sum(spans) / 1e6)
    assert st["median_ms"] == pytest.approx(sorted(spans)[1] / 1e6)
    assert P.totals("s") == (3, sum(spans))
    assert P.stats("never") == {"count": 0, "sum_ms": 0.0, "median_ms": None}
    assert P.totals("never") == (0, 0)
    P.reset()
    assert P.totals("s") == (0, 0)


def test_ring_keeps_the_last_samples_and_counts_all():
    table = P.SpanTable(ring=4)
    for i in range(10):
        table.add("s", i)
    st = table.stats("s")
    assert st["count"] == 10 and st["sum_ms"] == pytest.approx(45 / 1e6)
    assert st["median_ms"] == pytest.approx(7.5 / 1e6)  # of the ring: 6, 7, 8, 9
    assert P.RING == 4096


def test_table_is_exact_under_many_threads():
    threads, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with P.span("outer"):
                    with P.span("inner"):
                        pass
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert P.totals("outer")[0] == P.totals("inner")[0] == threads * per
    assert P.totals("inner")[1] <= P.totals("outer")[1]


# ----------------------------------------------------------------- profiler

def test_span_under_the_profiler_is_in_the_trace_and_not_the_table(tmp_path):
    with P.trace(str(tmp_path), cuda=False) as prof:
        with P.span("gdn.test.traced") as sp:
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert sp.ns > 0
    events = json.load(open(prof.trace_path))["traceEvents"]
    assert [e["cat"] for e in events if e.get("name") == "gdn.test.traced"] == [
        "user_annotation"]
    assert P.totals("gdn.test.traced") == (0, 0)
    with P.span("gdn.test.traced"):
        pass
    assert P.totals("gdn.test.traced")[0] == 1


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with P.span("quiet"):
        pass
    assert P.totals("quiet")[0] == 1


# ------------------------------------------------------------------ program

TINY = tcfg.Config(model=tcfg.ModelConfig(image_size=HW, enc_channels=(8, 16),
                                          dec_channels=(16, 8), dtype="float32"))


@pytest.mark.parametrize("n,b", [(7, 3), (6, 2), (1, 4)])
def test_predict_spans_a_batch_and_joins_once(n, b):
    from gdn_tpu_torch.serving import BatchedPredictor

    pred = BatchedPredictor(TINY, init_params(TINY.model, torch.Generator().manual_seed(0)),
                            batch_size=b, device="cpu")
    rgbs = np.random.default_rng(0).integers(0, 255, (n, *HW, 3), dtype=np.uint8)
    P.reset()
    assert pred.predict(rgbs, wire="u16").shape == (n, *HW)
    batches = math.ceil(n / b)
    for name, k in (("stage", batches), ("launch", batches), ("join", 1)):
        assert P.totals(f"gdn.predict.{name}")[0] == k, name
    pred.predict(rgbs[:1])
    assert P.totals("gdn.predict.join")[0] == 2


class _Lines:
    def __init__(self):
        self.lines = []

    def log(self, **kw):
        self.lines.append(kw)


@pytest.mark.parametrize("k,log_every", [(5, 2), (3, 1)])
def test_epoch_loop_spans_each_step_and_each_read_back(k, log_every):
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.train.loop import _epoch_loop, stage1_state
    from gdn_tpu_torch.train.steps import make_stage1_step

    cfg = tcfg.Config(model=TINY.model, data=tcfg.DataConfig(batch_size=2),
                      train=tcfg.TrainConfig(steps_per_epoch=k, log_every=log_every))
    state = stage1_state(cfg, "cpu")
    data = iter(SyntheticDataset(2, *HW, 80.0, seed=0, device="cpu"))
    lines = _Lines()
    P.reset()
    _epoch_loop(make_stage1_step(cfg), state, data, k, lines, 2, log_every,
                torch.device("cpu"))
    for name in ("step", "forward", "backward", "update"):
        assert P.totals(f"gdn.train.{name}")[0] == k, name
    assert P.totals("gdn.train.readback")[0] == len(lines.lines) == math.ceil(k / log_every)
    keys = ("host_step_ms", "host_forward_ms", "host_backward_ms", "host_update_ms",
            "readback_ms")
    for line in lines.lines:
        assert all(line[key] > 0 for key in keys)
        # a step holds its forward, backward and update
        assert line["host_step_ms"] > (line["host_forward_ms"] + line["host_backward_ms"]
                                       + line["host_update_ms"])
    # each line's means over the steps since the last: together, every step
    per_line = [min(log_every, k - i * log_every) for i in range(len(lines.lines))]
    assert sum(line["host_step_ms"] * n for line, n in zip(lines.lines, per_line)) == (
        pytest.approx(P.totals("gdn.train.step")[1] / 1e6))


class _Echo:
    """A predictor stand-in: the batcher's own work, no net."""

    batch_size = 4
    image_size = HW

    def predict(self, rgbs, wire="f32"):
        return rgbs[..., 0].astype(np.float32)


def test_batcher_spans_and_stats_report_queue_wait_and_flush():
    from gdn_tpu_torch.server import DepthServer

    srv = DepthServer(None, predictor=_Echo(), max_wait_ms=20.0, warmup=False)
    srv.start()
    try:
        rgbs = [np.full((*HW, 3), i, np.uint8) for i in range(6)]
        out = [None] * 6

        def call(i):
            out[i] = srv.batcher.predict(rgbs[i], timeout=30)

        ts = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert all(int(o[0, 0]) == i for i, o in enumerate(out))
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=30) as r:
            st = json.loads(r.read())
    finally:
        srv.stop()
    assert st["requests"] == st["batched_items"] == 6
    assert st["mean_queue_wait_ms"] > 0 and st["mean_flush_ms"] > 0
    assert st["mean_queue_wait_ms"] < st["mean_latency_ms"]
    assert "queue_wait_ms_sum" not in st and "flush_ms_sum" not in st
    n, ns = P.totals("gdn.batcher.flush")
    assert n == st["batches"]
    assert st["mean_flush_ms"] == pytest.approx(ns / n / 1e6)


class _Slow(_Echo):
    """Holds each batch of one 0.2 s, and says when it has begun."""

    batch_size = 1

    def __init__(self):
        self.begun = threading.Event()

    def predict(self, rgbs, wire="f32"):
        self.begun.set()
        time.sleep(0.2)
        return super().predict(rgbs, wire)


def test_queue_wait_runs_from_submit_until_the_worker_takes_the_request():
    from gdn_tpu_torch.server import DynamicBatcher

    slow = _Slow()
    batcher = DynamicBatcher(None, None, max_wait_ms=0.0, predictor=slow)
    try:
        rgb = np.zeros((*HW, 3), np.uint8)
        first = threading.Thread(target=batcher.predict, args=(rgb,), kwargs={"timeout": 30})
        first.start()
        assert slow.begun.wait(30)
        t0 = time.perf_counter()
        batcher.predict(rgb, timeout=30)  # queued behind the first batch
        waited_ms = (time.perf_counter() - t0) * 1e3
        first.join(timeout=30)
    finally:
        batcher.stop()
    st = batcher.stats
    assert st["batches"] == 2 and st["requests"] == 2
    # the second request waited out most of the first batch's 0.2 s; the
    # first was taken at once
    assert 100.0 < st["queue_wait_ms_sum"] < waited_ms
    assert st["flush_ms_sum"] >= 400.0


def test_stats_of_an_idle_server_are_zero():
    from gdn_tpu_torch.server import DepthServer

    srv = DepthServer(None, predictor=_Echo(), warmup=False)
    srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=30) as r:
            st = json.loads(r.read())
    finally:
        srv.stop()
    assert st["mean_queue_wait_ms"] == st["mean_flush_ms"] == st["mean_latency_ms"] == 0.0
