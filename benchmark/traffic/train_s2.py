"""Stage-2 guided training: the port's stage-2 step
(``train.steps.make_stage2_step``) driven by its epoch loop
(``train.loop._epoch_loop``, with the loss read back every
``log_every`` steps), on batches drawn on the card from the seed.

Set-up builds one train state (the G-net, its frozen decoder, Adam) and
the frozen D-net from the seed's weights, then drives the loop through
its first three steps, which compile and warm every shape.  Those steps
are the ones checked: the loss of each, the first gradient of each
trained leaf as Adam holds it after one step (its first moment over 1 -
beta1) and each leaf's change after three.  The window then goes on
with the same state and stream until ``--seconds`` have passed.

The reference (``reference.model.stage2_steps``, float32, TF32 off)
follows the same three steps once the window has closed and the
program's state is freed.  Parameters (``params`` of the cell):
``batch``, ``slice_steps`` (steps the traced slice profiles).
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import torch

from harness import inputs
from harness.core import Run, program_config

STEPS_CHECKED = 3


class _Records:
    """The loop's logger: keeps every logged line."""

    def __init__(self):
        self.lines: List[Dict] = []

    def log(self, **kw) -> None:
        self.lines.append(kw)


class _Deadline:
    """Stops the loop (as a preemption request would) once the clock
    passes ``t_end`` or ``steps`` steps have run."""

    def __init__(self, t_end: float = math.inf, steps: int = 1 << 62):
        self.t_end, self.left, self.requested = t_end, steps, False

    def stop(self, mesh=None, device=None) -> bool:
        self.left -= 1
        self.requested = self.left <= 0 or time.perf_counter() >= self.t_end
        return self.requested


def build(run: Run):
    """The program's train state, frozen D-net, step and batch stream,
    from the seed's weights; and the benchmark's copy of the weights."""
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import make_stage2_step

    cfgj, b, dev = run.cfgj, run.params["batch"], run.device
    cfg = program_config(cfgj, b)
    d_p, g_p = inputs.make_nets_params(cfgj, run.seed, dev)
    with torch.device(dev):
        d_net, g_net = DtoDNet(cfg.model), RtoDNet(cfg.model)
    d_net.load_state_dict(d_p, strict=True)
    g_net.load_state_dict(g_p, strict=True)
    d_net.requires_grad_(False)
    state = TrainState(g_net, cfg.train, cfg.train.steps_per_epoch, freeze_decoder=True)
    h, w = cfgj["image_size"]
    stream = inputs.train_batches(run.seed, b, h, w, cfgj["max_depth"], dev)
    return cfg, state, d_net, make_stage2_step(cfg), stream, d_p, g_p


def loop(cfg, step_fn, state, d_net, stream, records, dev, stop, steps=1 << 40):
    """The program's epoch loop over ``steps`` steps or until ``stop``."""
    from gdn_tpu_torch.train.loop import _epoch_loop

    return _epoch_loop(step_fn, state, stream, steps, records, cfg.data.batch_size,
                       cfg.train.log_every, dev, extra_args=(d_net,), preemption=stop)


def norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


def first_steps(cfg, state, d_net, step_fn, stream, g_p, dev):
    """Drive the loop through its first three steps; the program's
    readings: losses, first gradients' norms, changes' norms, by leaf."""
    records = _Records()
    beta1 = cfg.train.beta1
    grads = first = None
    for i in range(STEPS_CHECKED):
        state = loop(cfg, step_fn, state, d_net, stream, records, dev, None, steps=1)
        if i == 0:
            # Adam's first moment after one step is (1 - beta1) times the
            # gradient; a parameter it holds no moment for got none
            opt = state.optimizer.state
            first = [opt[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in opt.get(p, {})
                     else torch.zeros_like(p) for p in state.params]
            grads = norms(first)
            first = dict(zip(state.names, first))
    params = dict(zip(state.names, state.params))
    changes = norms([params[k].detach() - g_p[k] for k in state.names])
    losses = [float(r["total"]) for r in records.lines]
    return state, {"names": list(state.names), "losses": losses,
                   "grads": dict(zip(state.names, grads)),
                   "changes": dict(zip(state.names, changes)), "first": first}


def reference_readings(run: Run, d_p, g_p, precision="fp32", rows=slice(None),
                       cfgj=None) -> Dict:
    """The reference's readings over the same first three batches."""
    from reference.model import reference_mode, stage2_steps

    cfgj = cfgj or run.cfgj
    b, dev = run.params["batch"], run.device
    h, w = cfgj["image_size"]
    batches = [inputs.train_batch(run.seed, i, b, h, w, cfgj["max_depth"], dev)
               for i in range(STEPS_CHECKED)]
    with reference_mode():
        losses, first, after = stage2_steps(g_p, d_p, batches, cfgj, precision, rows)
    names = list(first)
    grads = dict(zip(names, norms([first[k] for k in names])))
    changes = dict(zip(names, norms([after[k] - g_p[k] for k in names])))
    return {"names": names, "losses": losses, "grads": grads, "changes": changes,
            "first": first}


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers: the widest relative gap of the three losses;
    of the first gradients' norms by leaf, of the norm of the first
    gradients' difference by leaf, and of the changes' norms by leaf,
    each against the larger of the leaf's reference norm and the median
    leaf's.  The norms alone agree to within a few hundredths under the
    control too (rounding errors of either sign cancel in a norm): the
    difference is the number that tells a lower precision apart.  Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of the change."""
    loss = max(abs(a - r) / abs(r) for a, r in zip(got["losses"], ref["losses"]))
    names = ref["names"]
    if sorted(got["names"]) != sorted(names):
        return {"loss_gap": loss, "grad_gap": math.inf, "grad_diff_gap": math.inf,
                "change_gap": math.inf}
    g_med = statistics.median(ref["grads"][k] for k in names)
    grad = max(abs(got["grads"][k] - ref["grads"][k]) / max(ref["grads"][k], g_med)
               for k in names)
    diff = norms([got["first"][k] - ref["first"][k] for k in names])
    grad_diff = max(d / max(ref["grads"][k], g_med) for k, d in zip(names, diff))
    moved = [k for k in names if ref["grads"][k] >= 1e-3 * g_med]
    c_med = statistics.median(ref["changes"][k] for k in moved)
    change = max(abs(got["changes"][k] - ref["changes"][k]) / max(ref["changes"][k], c_med)
                 for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "grad_diff_gap": grad_diff,
            "change_gap": change}


def look(got: Dict, ref: Dict) -> Dict:
    """What lies behind ``gaps``: each step's loss gap, and for the
    gradients and the changes the worst leaf, its reference norm over the
    median leaf's, and the median leaf's gap."""
    out = {"loss_steps": [abs(a - r) / abs(r) for a, r in zip(got["losses"], ref["losses"])]}
    names = ref["names"]
    med = statistics.median(ref["grads"].values())
    diff = dict(zip(names, norms([got["first"][k] - ref["first"][k] for k in names])))
    rel = {k: diff[k] / max(ref["grads"][k], med) for k in names}
    worst = max(rel, key=rel.get)
    out["grad_diff"] = {"worst": worst, "worst_gap": rel[worst],
                        "median_gap": statistics.median(rel.values())}
    for key in ("grads", "changes"):
        med = statistics.median(ref[key].values())
        rel = {k: abs(got[key][k] - ref[key][k]) / max(ref[key][k], med) for k in ref[key]}
        worst = max(rel, key=rel.get)
        out[key] = {"worst": worst, "worst_gap": rel[worst],
                    "worst_norm_over_median": ref[key][worst] / med,
                    "median_gap": statistics.median(rel.values())}
    return out


def run(r: Run) -> None:
    from gdn_tpu_torch import kernels

    dev = r.device
    if dev.type == "cuda":
        kernels.load_all()
    cfg, state, d_net, step_fn, stream, d_p, g_p = build(r)
    state, got = first_steps(cfg, state, d_net, step_fn, stream, g_p, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    r.setup_done()

    records = _Records()
    step0 = state.step
    t0 = time.perf_counter()
    state = loop(cfg, step_fn, state, d_net, stream, records, dev,
                 _Deadline(t_end=t0 + r.seconds))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    steps = state.step - step0
    b = r.params["batch"]
    r.e2e["train_imgs_per_s"] = steps * b / elapsed
    r.attempted = steps
    bad = [x for x in records.lines if not math.isfinite(float(x["total"]))]
    r.failed = steps if bad else 0
    r.sound = not bad
    r.ctx.update(kind="train", batch=b, window_s=elapsed, window_units=steps,
                 cfg=r.cfgj, logged=len(records.lines))
    r.note(f"window: {steps} steps of {b} in {elapsed:.3f} s, "
           f"{len(records.lines)} loss read-backs")

    if r.trace:
        from harness.trace import profiled

        n = r.params["slice_steps"]
        r.slice = profiled(lambda: loop(cfg, step_fn, state, d_net, stream, _Records(), dev,
                                        _Deadline(steps=n)))
        r.ctx["slice_units"] = n  # steps, as window_units
    if dev.type == "cuda":
        r.memory_peak = torch.cuda.max_memory_allocated(dev)
    del state, d_net, step_fn, stream
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference_readings(r, d_p, g_p)
    for name, v in gaps(got, ref).items():
        r.check(name, v, r.cell["limits"][name])
    med = statistics.median(ref["grads"].values())
    still = sum(v < 1e-3 * med for v in ref["grads"].values())
    r.note(f"reference: {time.perf_counter() - t:.2f} s; program losses {got['losses']}, "
           f"reference {ref['losses']}; {still} of {len(ref['names'])} leaves left out of "
           "the change (gradient under a thousandth of the median leaf's)")
