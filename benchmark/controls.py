#!/usr/bin/env python3
"""Readings that set a cell's limits, at the cell's own size on the card:
the program's, the control's and the planted faults', seed by seed, in
one process.  The benchmark's own runs do not run this.

    python3 benchmark/controls.py --workload <cell> --seeds 1 2 3 [--rehearse]

Training cells (no window is needed): the program's first three steps
(as ``run.py``'s set-up drives them), the control (the reference in
float8 put in the program's place, e4m3 values and e5m2 gradients: the
nearest precision below the configuration's bfloat16), and a fault planted in the reference put in
the program's place (half of each batch left out, the mean taken over
the rest), and a state left unchanged (the reference at a zero learning
rate, its first gradient read as 0: Adam holds no moment).  Each against
the float32 reference.

Serving cells: the program's predictor on a sample of the pool at the
cell's batch, the control (the port's own int8 path,
``model.quant="int8"``, calibrated on the pool), and a fault (each
answer replaced by the next frame's), each against the reference.

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import core, inputs, serving  # noqa: E402


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_readings(r: core.Run) -> dict:
    from gdn_tpu_torch import kernels

    drv = core.load_module("traffic", r.cell["kind"])
    if r.device.type == "cuda":
        kernels.load_all()
    cfg, state, d_net, step_fn, stream, d_p, g_p = drv.build(r)
    state, got = drv.first_steps(cfg, state, d_net, step_fn, stream, g_p, r.device)
    del state, d_net, step_fn, stream
    _free()
    ref = drv.reference_readings(r, d_p, g_p)
    half = slice(0, r.params["batch"] // 2)
    out = {}
    frozen = drv.reference_readings(r, d_p, g_p, cfgj={**r.cfgj, "train": {
        **r.cfgj["train"], "lr": 0.0}})
    # a step that returns its state unchanged: Adam holds no moment, so the
    # first gradient as the optimizer gets it reads 0, and nothing moves
    frozen["grads"] = {k: 0.0 for k in frozen["names"]}
    frozen["first"] = {k: torch.zeros_like(v) for k, v in frozen["first"].items()}
    for name, got in (("program", got),
                      ("control_fp8", drv.reference_readings(r, d_p, g_p, "fp8")),
                      ("fault_half_batch", drv.reference_readings(r, d_p, g_p, rows=half)),
                      ("fault_state_unchanged", frozen)):
        out[name] = drv.gaps(got, ref)
        out[f"{name}_look"] = drv.look(got, ref)
    return out


def serve_readings(r: core.Run, n: int = 256) -> dict:
    p, cfgj = r.params, r.cfgj
    h, w = cfgj["image_size"]
    g_p = serving.g_params(r)
    pool = inputs.frame_pool(r.seed, p["pool"], h, w, r.device)
    rng = np.random.default_rng(inputs.stream_seed(r.seed, 7))
    idx = rng.choice(p["pool"], min(n, p["pool"]), replace=False)
    frames = pool[idx]
    ref = serving.reference_depth(r, g_p, pool, list(idx))
    out = {}
    for name, control in (("program", False), ("control_int8", True)):
        pred = serving.predictor(r, g_p, p["batch"], control=control,
                                 calib=[pool[s:s + 64] for s in range(0, min(256, len(pool)), 64)])
        depth = pred.predict(frames, wire="u16")
        answers = list(zip(idx.tolist(), depth))
        out[name] = serving.gaps(answers, ref)
        out[f"{name}_look"] = serving.look(answers, ref)
        if not control:
            shifted = list(zip(idx.tolist(), np.roll(depth, 1, axis=0)))
            out["fault_altered_answer"] = serving.gaps(shifted, ref)
            out["fault_altered_answer_look"] = serving.look(shifted, ref)
        del pred
        _free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    cfgj = core.load_config(cell["config"])
    if args.rehearse:
        cfgj = {**cfgj, "image_size": cell["rehearse"]["image_size"]}
        cell = {**cell, "params": {**cell["params"], **cell["rehearse"]["params"]}}
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("controls.py measures on the card; none found", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    for seed in args.seeds:
        r = core.Run(cell, cfgj, seed, 0.0, False, device)
        kind = "train" if cell["kind"].startswith("train") else "serve"
        out = train_readings(r) if kind == "train" else serve_readings(r)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
