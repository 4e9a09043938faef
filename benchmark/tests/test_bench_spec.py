"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic module and per-layer reader found by its name."""

import json
import os
import re

import pytest

from harness import core

SPEC = core.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m.get("workloads", CELLS):
            reports = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reports, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    data = core.load_cell(cell)
    assert (data["config"], data["traffic"], data["chips"], data["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    cfg = core.load_config(data["config"])
    assert cfg["name"] == data["config"]
    assert os.path.exists(os.path.join(core.BENCH, "traffic", f"{data['kind']}.py"))
    assert set(data["limits"]) and all(v > 0 for v in data["limits"].values())
    # every cell reports setup_s, one other end-to-end metric and a per-layer one
    e2e = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", CELLS)]
    assert len(e2e) >= 2
    assert any(cell in m.get("workloads", CELLS) for m in SPEC["per_layer"])


def test_configs_files():
    for c in SPEC["configs"]:
        path = os.path.join(core.ROOT, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_reader_found_and_silent_elsewhere(metric):
    mod = core.load_module("metrics", metric)
    assert mod.read({"kind": "none"}) is None


def test_program_config_matches_the_presets():
    from gdn_tpu_torch.config import kitti_config, nyu_config

    for name, preset in (("gdn-kitti", kitti_config()), ("gdn-nyu", nyu_config())):
        cfg = core.program_config(core.load_config(name), 8)
        assert cfg.model == preset.model
        assert cfg.loss == preset.loss


def test_percentile_counts_missing_as_slowest():
    assert core.percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.0
    assert core.percentile([1.0] * 19 + [float("inf")], 95) == 1.0
    assert core.percentile([1.0] * 18 + [float("inf")] * 2, 95) == float("inf")
