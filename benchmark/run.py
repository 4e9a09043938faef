#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell (``BENCHMARK.json``'s ``workloads``) names its file
``benchmark/workloads/<cell>.json``, which names a configuration
(``benchmark/configs/<config>.json``) and a kind of traffic
(``benchmark/traffic/<kind>.py``) with its parameters.  That module
builds the system under test (``gdn_tpu_torch``) from the seed, warms it
(set-up), runs it for ``--seconds`` (the window), and checks what the
window produced against the plain reference (``benchmark/reference``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read
by ``benchmark/metrics/<name>.py`` from a profiled slice after the
window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number with its limit, also the last lines of
standard error.

No card (or fewer than the cell asks for): exit 2, no result.
``--rehearse`` runs the same path on the CPU at the cell's rehearsal
size with the kernels' plain forms, to find path and shape faults; its
numbers carry a ``cpu.`` prefix and measure nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import core  # noqa: E402

T_PROC = core.process_start()
# caches of the program and its libraries: fixed directories inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH, ".cache", "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _selected(spec, cell: str, kind: str, reported=()):
    """The metrics of ``spec[kind]`` this cell reports: those that list
    it, and those without a list (per-layer: whose ``moves`` it reports)."""
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def _smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "?"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(core.FORBIDDEN))


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = core.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None and not args.rehearse:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    # a rehearsal may try a cell that its file holds and BENCHMARK.json does not yet
    chips = entry["chips"] if entry is not None else cell["chips"]
    cfgj = core.load_config(cell["config"])

    import torch

    if args.rehearse:
        reh = cell["rehearse"]
        cfgj = {**cfgj, "image_size": reh["image_size"]}
        cell = {**cell, "params": {**cell["params"], **reh["params"]}}
        device = torch.device("cpu")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            print(f"cell {args.workload} needs {chips} CUDA device(s), found {have}; "
                  "the benchmark measures the card and does not run on the CPU",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        print(f"[bench] {torch.cuda.get_device_name(0)}, {_smi('name,power.limit,clocks.sm')}",
              file=sys.stderr, flush=True)

    run = core.Run(cell, cfgj, args.seed, args.seconds, bool(args.trace), device, T_PROC)
    core.load_module("traffic", cell["kind"]).run(run)

    e2e = _selected(spec, args.workload, "end_to_end")
    missing = [m["name"] for m in e2e if m["name"] not in run.e2e]
    if missing:
        print(f"the run measured no {missing}", file=sys.stderr)
        return 3
    if args.trace:
        ctx = {**run.ctx, "slice": run.slice}
        metrics = {}
        for m in _selected(spec, args.workload, "per_layer", [m["name"] for m in e2e]):
            v = core.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]} for m in e2e}

    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark runs the port alone", file=sys.stderr)
        return 4

    if args.rehearse:
        metrics = {f"cpu.{k}": v for k, v in metrics.items()}
        device_rec = {"platform": "cpu", "kind": "rehearsal", "count": 0,
                      "memory_peak_bytes": 0}
    else:
        device_rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": chips, "memory_peak_bytes": int(run.memory_peak)}
        if args.trace:
            device_rec.update(busy_s=run.slice.busy_s(), window_s=run.slice.window_s)
    result = {"correct": run.correct, "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": device_rec}
    if args.trace and run.slice is not None:
        result["breakdown"] = {"device_ops": run.slice.top_ops(10),
                               "idle_gaps": run.slice.idle_gaps(10)}
        print(f"[bench] trace read in {run.slice.read_s:.2f} s", file=sys.stderr)
    result["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for n, v, lim in run.checks}
    if not run.sound:
        result["checks"]["answers_missing"] = {"value": int(run.failed), "limit": 0}
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
