"""The convergence protocol on a shared draw: the port against the JAX
package, both on the CPU, from one init and one stream of batches.

``scripts/convergence_torch.py`` and ``scripts/convergence.py`` each draw
their own weights (a torch generator, a JAX key) and their own training
batches, so their ``a1`` can differ by the draw alone.  Here, per seed,
the JAX package draws everything: the D-net's and the G-net's init
(``create_state`` with ``PRNGKey(seed)``), the training batches of
``gdn_tpu.data.synthetic.SyntheticDataset(seed)`` and ``(seed + 1000)``
and the eval split (``SyntheticEvalDataset``).  The weights are carried
to the port by ``params_from_flax``; then each package runs the
protocol's 300 steps a stage (``make_stage1_step``, its own decoder
transferred into the shared G-net init, ``make_stage2_step``) on the same
numpy arrays and scores the same eval split.

Per seed it records:

- ``departure``: the first step of each stage whose total loss leaves
  the trajectory tolerance of ``tests/test_torch_train.py`` (atol 1e-4,
  rtol 1e-3), or None;
- ``param_gap``: the largest gap between the two packages' parameters at
  the end of each stage, relative to each tensor's largest magnitude,
  and the tensor;
- ``probes``: at steps 0, 100, 200 and 299 of each stage, one step's
  loss terms and gradients of both packages at the JAX run's weights
  there (stage 2 guided by the JAX run's D-net): the largest relative
  gap of a term and of a gradient tensor (relative to its largest
  magnitude), beside the same gaps between JAX and JAX itself on the
  batch with its images in reverse order (the same function, summed in
  another order); then the step taken apart (``_modules``): the net's
  VJP under one cotangent, the depth terms' gradient at one prediction
  with and without exact ties, the ties, and how far the two forwards'
  rounding moves that gradient;
- ``reordered``: JAX's pipeline again with every batch's images in
  reverse order: the step each stage's total loss leaves the tolerance
  of the JAX run's, and its ``a1``.  How far JAX's own rounding carries a
  run, like for like with the port's;
- ``control``: the port's pipeline again from the init with every weight
  moved by one float32 ulp (``w * (1 + 2**-23)``, sign by a seeded
  draw): the same figures against the port's run;
- ``a1`` of each package and their difference.

It runs for minutes (``-m slow``).  As a script it prints one JSON line a
seed and then the means::

    JAX_PLATFORMS=cpu python tests/test_torch_convergence_shared.py \\
        --seeds 0 1 2 --dtype float32 [--norm none] [--steps 300]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEEDS = (0, 1, 2)
STEPS = 300  # a stage, as the protocol
BATCH = 16
HW = (32, 64)
LR = 5e-4
EVAL_IMAGES = 30
TRAJ_ATOL, TRAJ_RTOL = 1e-4, 1e-3  # tests/test_torch_train.py's trajectory bound
PROBE_AT = (0, 100, 200, 299)
ULP = 2.0 ** -23


def _cfgs(seed, dtype, norm, steps):
    """(JAX Config, port Config) of the protocol for one seed: the JAX
    script's fields, with the compute dtype set on both."""
    from gdn_tpu import config as jcfg
    from gdn_tpu_torch import config as tcfg

    model = dict(image_size=HW, norm=norm, dtype=dtype)
    train = dict(ckpt_dir="", lr=LR, epochs=1, steps_per_epoch=steps, seed=seed,
                 log_every=100)
    data = dict(batch_size=BATCH, dataset="synthetic")
    return (jcfg.Config(model=jcfg.ModelConfig(**model), train=jcfg.TrainConfig(**train),
                        data=jcfg.DataConfig(**data)),
            tcfg.Config(model=tcfg.ModelConfig(**model, use_pallas_gn=True),
                        train=tcfg.TrainConfig(**train), data=tcfg.DataConfig(**data)))


def _flax_sd(params):
    import jax

    from gdn_tpu_torch.checkpoint import params_from_flax

    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _gap(got, want):
    """(max over tensors of max|got - want| / max|want|, that tensor)."""
    worst = (0.0, None)
    for k, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max()) or 1.0
        worst = max(worst, (float(np.abs(np.asarray(got[k]) - w).max()) / scale, k))
    return worst


def _departure(ref, other):
    for t, (j, p) in enumerate(zip(ref, other)):
        if not np.isfinite(p) or abs(p - j) > TRAJ_ATOL + TRAJ_RTOL * abs(j):
            return t
    return None


def _batches(seed, n, max_depth):
    from gdn_tpu.data.synthetic import SyntheticDataset

    it = iter(SyntheticDataset(BATCH, *HW, max_depth, seed=seed))
    return [{k: np.asarray(v) for k, v in next(it).items()} for _ in range(n)]


def _torch(b):
    import torch

    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


class _Jax:
    """The JAX package's half: its nets, steps and step losses."""

    def __init__(self, jc):
        import jax

        from gdn_tpu.losses import total_loss
        from gdn_tpu.models import DtoDNet, RtoDNet
        from gdn_tpu.train import steps

        self.jc, self.d, self.g = jc, DtoDNet(cfg=jc.model), RtoDNet(cfg=jc.model)
        self.step1, self.step2 = steps.make_stage1_step(jc), steps.make_stage2_step(jc)
        self.loss1 = jax.jit(jax.value_and_grad(
            lambda p, b: steps._stage1_loss(p, self.d.apply, b, jc), has_aux=True))
        self.loss2 = jax.jit(jax.value_and_grad(
            lambda p, d, b: steps._stage2_loss(p, d, self.g.apply, self.d.apply, b, jc),
            has_aux=True))
        self.nets = {1: self.d, 2: self.g}
        self.vjp = {k: jax.jit(lambda p, x, r, net=net: jax.vjp(
            lambda p: net.apply({"params": p}, x)["depth"], p)[1](r)[0])
            for k, net in self.nets.items()}
        self.pred = {k: jax.jit(lambda p, x, net=net: net.apply({"params": p}, x)["depth"])
                     for k, net in self.nets.items()}
        self.depth_loss_grad = jax.jit(jax.grad(lambda pred, gt, mask: total_loss(
            pred, gt, mask, jc.loss, jc.model.max_depth)["total"]))


def _reversed(b):
    """The batch with its images in reverse order."""
    return {k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}


def _terms_gap(got, want):
    return max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-12)
               for k in want)


def _tie_pairs(pool, grads, pred, gt, mask, scales):
    """[(scale, (B, H_s, W_s - 1) x ties, (B, H_s - 1, W_s) y ties)] of a
    package's gradient term, with its own ``pool`` and ``grads``: the
    valid forward-difference pairs whose argument ``d pred - d gt`` is
    exactly 0.  There JAX's XLA route differentiates ``jnp.abs`` as 1,
    its TPU kernel (``gdn_tpu/kernels/fused_loss.py``, ``jnp.sign``) and
    the port as 0."""
    out = []
    for s in range(scales):
        if s > 0:
            m_w = pool(mask)
            pred, gt, mask = pool(pred), pool(gt * mask) / np.maximum(m_w, 1e-6), m_w > 0.999
        (pdx, pdy), (gdx, gdy) = grads(pred), grads(gt)
        mask = np.asarray(mask, np.float32)
        out.append((s, (np.asarray(pdx - gdx) == 0) & (mask[:, :, 1:] * mask[:, :, :-1] > 0),
                    (np.asarray(pdy - gdy) == 0) & (mask[:, 1:] * mask[:, :-1] > 0)))
    return out


def _tie_footprint(pred, gt, mask, scales):
    """(B, H, W) of the pixels whose depth-term gradient an exact tie
    reaches, and the ties' count: a tie of either package's gradient term
    (a pair at scale s covers 2**s x 2**(s + 1) pixels) or of the L1 term
    (``pred == gt`` on a valid pixel; there too XLA's ``jnp.abs`` takes 1
    and the TPU kernel's ``jnp.sign`` and the port 0)."""
    import jax
    import torch

    from gdn_tpu import losses as jl
    from gdn_tpu_torch import losses as tl

    p, g, m = pred[..., 0], gt[..., 0], mask[..., 0]
    with jax.default_device(jax.devices("cpu")[0]):
        jax_pairs = _tie_pairs(lambda x: np.asarray(jl._avgpool2(x)),
                               lambda x: [np.asarray(v) for v in jl._grads(x)], p, g, m, scales)
    port_pairs = _tie_pairs(lambda x: tl._avgpool2(torch.from_numpy(np.asarray(x))).numpy(),
                            lambda x: [v.numpy() for v in tl._grads(torch.from_numpy(
                                np.asarray(x)))], p, g, m, scales)
    near = (p == g) & (m > 0)
    n = int(near.sum())
    for s, tx, ty in jax_pairs + port_pairs:
        k = 2 ** s
        for bb, y, x in np.argwhere(tx):
            near[bb, y * k:(y + 1) * k, x * k:(x + 2) * k] = True
        for bb, y, x in np.argwhere(ty):
            near[bb, y * k:(y + 2) * k, x * k:(x + 1) * k] = True
        n += int(tx.sum() + ty.sum())
    return near, n


def _modules(jx, tc, stage, params, batch, net):
    """The step taken apart at the JAX weights ``params``, the port's
    ``net`` holding the same: the net's parameter gradients under one
    seeded cotangent of its depth (the VJP alone); the depth terms'
    gradient in the prediction, both packages' losses at JAX's
    prediction, off the pixels an exact tie of the gradient term reaches
    (the loss alone) and everywhere (``loss_grad_at_ties``); the ties;
    the JAX loss gradient at the port's prediction against at JAX's (how
    far the two forwards' rounding moves it); and the masked pixels whose
    L1 sign differs between the two predictions."""
    import torch

    from gdn_tpu_torch.losses import total_loss

    x = batch["depth" if stage == 1 else "rgb"]
    r = np.random.default_rng(stage).normal(size=batch["depth"].shape).astype(np.float32)
    jg = {k: v.numpy() for k, v in _flax_sd(jx.vjp[stage](params, x, r)).items()}
    net.zero_grad()
    out = net(_torch({"x": x})["x"])["depth"]
    (out * torch.from_numpy(r)).sum().backward()
    tg = {k: p.grad.numpy() for k, p in net.named_parameters() if p.grad is not None}
    jpred = np.asarray(jx.pred[stage](params, x))
    tpred = out.detach().numpy()
    gt, mask = batch["depth"], batch["mask"]

    want = np.asarray(jx.depth_loss_grad(jpred, gt, mask))
    pt = torch.from_numpy(jpred.copy()).requires_grad_(True)
    total_loss(pt, *(torch.from_numpy(v) for v in (gt, mask)), tc.loss,
               tc.model.max_depth)["total"].backward()
    gap = np.abs(pt.grad.numpy() - want)[..., 0]
    near, ties = _tie_footprint(jpred, gt, mask, tc.loss.grad_scales)
    scale = float(np.abs(want).max())
    moved = np.asarray(jx.depth_loss_grad(tpred, gt, mask))
    flips = (np.sign(tpred - gt) != np.sign(jpred - gt)) & (mask > 0)
    return {"net_vjp": list(_gap(tg, {k: v for k, v in jg.items() if k in tg})),
            "loss_grad": float(np.where(near, 0.0, gap).max()) / scale,
            "loss_grad_at_ties": float(gap.max()) / scale, "ties": ties,
            "loss_grad_moved": float(np.abs(moved - want).max()) / scale,
            "l1_sign_flips": int(flips.sum())}


def _probe(jx, tc, stage, params, batch, d_params=None):
    """One step's terms and gradients of both packages at the JAX
    weights ``params`` -> (worst term gap, (worst gradient gap, tensor)),
    then the same of JAX on the reversed batch against JAX."""
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train import steps as tsteps

    if stage == 1:
        (_, jt), jg = jx.loss1(params, batch)
        (_, rt), rg = jx.loss1(params, _reversed(batch))
        net = DtoDNet(tc.model)
        net.load_state_dict(_flax_sd(params), strict=True)
        tt = tsteps._stage1_loss(net, _torch(batch), tc)
    else:
        (_, jt), jg = jx.loss2(params, d_params, batch)
        (_, rt), rg = jx.loss2(params, d_params, _reversed(batch))
        d_net = DtoDNet(tc.model)
        d_net.load_state_dict(_flax_sd(d_params), strict=True)
        d_net.requires_grad_(False)
        net = RtoDNet(tc.model)
        net.load_state_dict(_flax_sd(params), strict=True)
        net.decoder.requires_grad_(False)
        tt = tsteps._stage2_loss(net, d_net, _torch(batch), tc)
    tt["total"].backward()
    want = {k: v.numpy() for k, v in _flax_sd(jg).items()
            if not (stage == 2 and k.startswith("decoder."))}
    got = {k: p.grad.numpy() for k, p in net.named_parameters() if k in want}
    again = {k: v.numpy() for k, v in _flax_sd(rg).items() if k in want}
    return (_terms_gap({k: v.detach() for k, v in tt.items()}, jt), _gap(got, want),
            _terms_gap(rt, jt), _gap(again, want), _modules(jx, tc, stage, params, batch, net))


def _jax_run(jx, seed, steps, b1, b2, split, probe=True):
    """The JAX pipeline (with probes) -> dict."""
    from gdn_tpu.checkpoint import transfer_stage1_decoder
    from gdn_tpu.evaluate import evaluate
    from gdn_tpu.train import make_eval_forward
    from gdn_tpu.train.state import create_state

    jc, (h, w) = jx.jc, HW
    tc = _cfgs(seed, jc.model.dtype, jc.model.norm, steps)[1]
    js = create_state(jx.d, (1, h, w, 1), jc.train, steps)
    out = {"d_init": _flax_sd(js.params), "totals1": [], "totals2": [], "probes": []}
    for t, b in enumerate(b1):
        if probe and t in PROBE_AT:
            out["probes"].append((1, t, *_probe(jx, tc, 1, js.params, b)))
        js, terms = jx.step1(js, b)
        out["totals1"].append(float(terms["total"]))
    gs = create_state(jx.g, (1, h, w, 3), jc.train, steps, freeze_decoder=True)
    out["g_init"] = _flax_sd(gs.params)
    gs = gs.replace(params=transfer_stage1_decoder(gs.params, js.params))
    for t, b in enumerate(b2):
        if probe and t in PROBE_AT:
            out["probes"].append((2, t, *_probe(jx, tc, 2, gs.params, b, js.params)))
        gs, terms = jx.step2(gs, js.params, b)
        out["totals2"].append(float(terms["total"]))
    out["d"], out["g"] = _flax_sd(js.params), _flax_sd(gs.params)
    out["a1"] = float(evaluate(jc, gs.params, make_eval_forward(jc), split, verbose=False)["a1"])
    return out


def _port_run(tc, steps, d_init, g_init, b1, b2, split):
    """The port's pipeline from the given inits -> dict."""
    import torch

    from gdn_tpu_torch.checkpoint import transfer_stage1_decoder
    from gdn_tpu_torch.evaluate import evaluate
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train import steps as tsteps
    from gdn_tpu_torch.train.state import TrainState

    d_net = DtoDNet(tc.model)
    d_net.load_state_dict(d_init, strict=True)
    state, step = TrainState(d_net, tc.train, steps), tsteps.make_stage1_step(tc)
    out = {"totals1": [], "totals2": []}
    for b in b1:
        state, terms = step(state, _torch(b))
        out["totals1"].append(float(terms["total"]))
    d_sd = {k: v.clone() for k, v in d_net.state_dict().items()}
    g_net = RtoDNet(tc.model)
    g_net.load_state_dict(transfer_stage1_decoder(g_init, d_sd), strict=True)
    d_net.requires_grad_(False)
    state = TrainState(g_net, tc.train, steps, freeze_decoder=True)
    step = tsteps.make_stage2_step(tc)
    for b in b2:
        state, terms = step(state, d_net, _torch(b))
        out["totals2"].append(float(terms["total"]))
    out["d"], out["g"] = d_sd, {k: v.clone() for k, v in g_net.state_dict().items()}
    out["a1"] = float(evaluate(tc, tsteps.make_eval_forward(tc, g_net), split, verbose=False,
                               device="cpu")["a1"])
    torch.set_grad_enabled(True)
    return out


def _nudged(sd, seed):
    """Every weight moved by one float32 ulp, up or down by a seeded draw."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return {k: v * (1 + ULP * (torch.randint(0, 2, v.shape, generator=gen) * 2 - 1))
            for k, v in sd.items()}


def shared_run(seed, dtype="float32", norm="none", steps=STEPS, eval_images=EVAL_IMAGES,
               control=True):
    """One seed of the protocol on the shared draw -> its figures."""
    from gdn_tpu.data.synthetic import SyntheticEvalDataset

    t0 = time.perf_counter()
    jc, tc = _cfgs(seed, dtype, norm, steps)
    b1 = _batches(seed, steps, jc.model.max_depth)
    b2 = _batches(seed + 1000, steps, jc.model.max_depth)
    split = list(SyntheticEvalDataset(eval_images, *HW, jc.model.max_depth))
    j = _jax_run(_Jax(jc), seed, steps, b1, b2, split)
    p = _port_run(tc, steps, j["d_init"], j["g_init"], b1, b2, split)
    out = {"seed": seed, "dtype": dtype, "norm": norm, "steps": steps}
    for k in (1, 2):
        net = p["d" if k == 1 else "g"]
        out[f"stage{k}"] = {
            "departure": _departure(j[f"totals{k}"], p[f"totals{k}"]),
            "param_gap": _gap({n: v.numpy() for n, v in net.items()},
                              {n: v.numpy() for n, v in j["d" if k == 1 else "g"].items()}),
            "final_total": [j[f"totals{k}"][-1], p[f"totals{k}"][-1]]}
    out["probes"] = [{"stage": s, "step": t, "terms": a, "grads": list(g),
                      "jax_terms": ra, "jax_grads": list(rg), **mods}
                     for s, t, a, g, ra, rg, mods in j["probes"]]
    out["a1"] = {"jax": j["a1"], "port": p["a1"]}
    out["a1_gap"] = p["a1"] - j["a1"]
    if control:
        r = _jax_run(_Jax(jc), seed, steps, [_reversed(b) for b in b1],
                     [_reversed(b) for b in b2], split, probe=False)
        c = _port_run(tc, steps, _nudged(j["d_init"], seed), _nudged(j["g_init"], seed + 1),
                      b1, b2, split)
        for key, run, ref in (("reordered", r, j), ("control", c, p)):
            out[key] = {"departure1": _departure(ref["totals1"], run["totals1"]),
                        "departure2": _departure(ref["totals2"], run["totals2"]),
                        "a1": run["a1"], "a1_gap": run["a1"] - ref["a1"]}
    out["seconds"] = time.perf_counter() - t0
    return out


@pytest.mark.slow
@pytest.mark.parametrize("seed", SEEDS)
def test_norm_none_protocol_on_a_shared_draw(seed):
    """fp32, ``--norm none``: at every probe of both stages, each module
    of the port's step computes JAX's function at JAX's weights to
    rounding: the net's VJP within 1e-4 of each tensor's largest, the
    depth terms' gradient off exact ties within 1e-4 of its largest, the
    loss terms within the trajectory rtol; the losses stay finite.  The
    trajectories, the whole-step gradients and ``a1`` are recorded, not
    bounded: exact ties of the gradient term (where JAX's XLA route and
    its TPU kernel differentiate ``|0|`` differently) and the training's
    amplification part them, and a one-ulp nudge of the port's own init
    parts its run as far (``control``)."""
    res = shared_run(seed)
    for pr in res["probes"]:
        assert pr["terms"] <= TRAJ_RTOL, (pr, res)
        assert pr["net_vjp"][0] <= 1e-4 and pr["loss_grad"] <= 1e-4, (pr, res)
    for stage in ("stage1", "stage2"):
        assert np.isfinite(res[stage]["final_total"]).all(), (stage, res)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--norm", choices=["group", "none"], default="none")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--eval_images", type=int, default=EVAL_IMAGES)
    p.add_argument("--no_control", action="store_true", help="skip the one-ulp control run")
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    res = []
    for seed in args.seeds:
        res.append(shared_run(seed, args.dtype, args.norm, args.steps, args.eval_images,
                              not args.no_control))
        print(json.dumps(res[-1]), flush=True)
    print(json.dumps({"DONE": True, "dtype": args.dtype, "norm": args.norm,
                      "a1_mean": {k: float(np.mean([r["a1"][k] for r in res]))
                                  for k in ("jax", "port")}}), flush=True)


if __name__ == "__main__":
    main()
