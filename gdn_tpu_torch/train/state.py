"""Train state and optimizer (port of ``gdn_tpu/train/state.py``).

optax's pieces, written out so that the port updates its parameters as
the JAX package does:

- ``lr_schedule``: optax's step (staircase exponential), cosine and
  constant schedules, optionally joined after a linear warmup; the LR of
  update t (from 0) is ``schedule(t)``.
- ``clip_by_global_norm_``: optax's rule, ``g * max_norm / norm`` only
  when ``norm >= max_norm``, over the trainable parameters only (torch's
  ``clip_grad_norm_`` divides by ``norm + 1e-6``).
- ``torch.optim.Adam`` / ``AdamW`` compute optax's ``adam`` / ``adamw``
  update (same bias correction, eps outside the square root, decoupled
  weight decay scaled by the LR).
- Stage 2's frozen decoder: its parameters get ``requires_grad_(False)``
  and stay out of the optimizer (optax routes them to ``set_to_zero``).
- EMA: ``e = e * d + p * (1 - d)`` over every parameter after each
  update.
- ``grad_accum`` = k > 1: ``optax.MultiSteps``.  Each micro-step folds
  its gradient into a running mean (``acc += (g - acc) / (n + 1)``);
  the k-th hands the mean to clip, Adam and the EMA and clears it.
  ``step`` counts micro-steps (batches consumed, the data cursor) and
  ``updates`` the updates applied; the schedule runs in updates.
- Data parallel and FSDP (``parallel.mesh.shard_state`` sets ``mesh``):
  each micro-step sums the gradients of the ranks' loss shares, which
  is the single-device gradient of the global batch.  The plain
  (replicated) gradients go through one all-reduce of their
  concatenation; FSDP2 has reduce-scattered the sharded ones in the
  backward.  A trainable parameter that got no gradient is zero-filled
  first, so every rank reduces the same buffer.  Clipping takes the norm
  over the whole of each parameter; the EMA and the accumulator follow
  their parameter's placement; ``state_dict`` gathers the single-device
  layout (every rank must call it) and ``load_state_dict`` scatters it.
- Tensor and spatial parallelism (a ``"model"`` or ``"spatial"`` dim):
  the gradients are summed over the ``"data"`` x ``"spatial"`` ranks
  (``parallel.mesh.pixel_group``), a channel slice's like a whole
  parameter's: the model ranks' slices are different parameters, and a
  replicated parameter's gradient is the same on each model rank.  The
  clip counts the slices' squares over the model ranks and a replicated
  parameter once; ``state_dict`` gathers the slices over ``"model"``
  and ``load_state_dict`` cuts them again.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils._pytree import tree_map

from gdn_tpu_torch.config import TrainConfig
from gdn_tpu_torch.parallel.mesh import (
    full_tensor, global_sum, is_sharded, local, model_axis, pixel_group, shard_axis, shard_of,
    tp_dim, tp_gather, tp_slice,
)

Schedule = Callable[[int], float]


def _exponential_staircase(init: float, transition: int, rate: float) -> Schedule:
    if rate == 0:  # optax: a zero rate means a constant schedule
        return lambda t: init
    return lambda t: init if t <= 0 else init * rate ** math.floor(t / transition)


def _cosine(init: float, decay_steps: int) -> Schedule:
    def schedule(t):
        t = min(t, decay_steps)
        return init * 0.5 * (1 + math.cos(math.pi * t / decay_steps))

    return schedule


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Schedule:
    """cfg.schedule: "step" = lr * gamma^(update // (decay_epochs *
    steps_per_epoch / grad_accum)), "cosine" to 0 over the run, or
    "constant"; after a linear 0 -> lr warmup of cfg.warmup_steps /
    grad_accum updates when set.  ``decay_epochs`` and ``warmup_steps``
    count micro-steps, as in the JAX package; the schedule is taken in
    updates, so they are converted here."""
    accum = max(1, cfg.grad_accum)
    warmup = max(1, cfg.warmup_steps // accum) if cfg.warmup_steps else 0
    if cfg.schedule == "step":
        decay = _exponential_staircase(
            cfg.lr, max(1, cfg.decay_epochs * steps_per_epoch // accum), cfg.decay_gamma)
    elif cfg.schedule == "cosine":
        total = max(1, cfg.epochs * steps_per_epoch // accum)
        decay = _cosine(cfg.lr, max(1, total - warmup))
    elif cfg.schedule == "constant":
        decay = lambda t: cfg.lr  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r} (step|cosine|constant)")
    if not warmup:
        return decay

    def joined(t):
        if t < warmup:
            return cfg.lr * min(max(t, 0), warmup) / warmup
        return decay(t - warmup)

    return joined


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float,
                         columns=None) -> torch.Tensor:
    """Scale the grads of ``params`` in place by max_norm / norm when
    their global norm reaches max_norm (optax's rule).  Returns the norm.
    A sharded grad's norm is that of the whole parameter: the squares of
    the local shards are summed over the ranks.  ``columns``: (the model
    group, a flag a parameter) where some grads are tensor-parallel
    slices; their squares are summed over that group."""
    grads = [p.grad for p in params]
    norms = [torch.linalg.vector_norm(local(g).float()) for g in grads]
    fsdp = [is_sharded(g) for g in grads]
    tp = columns[1] if columns is not None else [False] * len(grads)
    split = []  # (flags, the group their squares are summed over)
    if any(fsdp):
        split.append((fsdp, shard_axis(next(g for g, f in zip(grads, fsdp) if f))[1]))
    if any(tp):
        split.append((tp, columns[0]))
    if split:
        sq = sum(global_sum(torch.stack([n for n, f in zip(norms, flags) if f]).square().sum(),
                            group) for flags, group in split)
        whole = [n for n, a, b in zip(norms, fsdp, tp) if not a and not b]
        if whole:
            sq = sq + torch.stack(whole).square().sum()
        norm = torch.sqrt(sq)
    else:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([local(g) for g in grads], factor)
    return norm


def _clone(obj):
    return tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor) else v, obj)


class TrainState:
    """A net, its optimizer over the trainable parameters, the LR
    schedule, the micro-step and update counts, the optional EMA of
    every parameter and, with grad_accum > 1, the gradient accumulator.

    With ``freeze_decoder`` the net's ``decoder`` parameters stop
    requiring grad: autograd then computes no weight gradient for them
    (activation gradients still flow through), and the optimizer never
    sees them."""

    def __init__(self, net: nn.Module, cfg: TrainConfig, steps_per_epoch: int,
                 freeze_decoder: bool = False):
        self.net = net
        self.cfg = cfg
        if freeze_decoder:
            net.decoder.requires_grad_(False)
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.step = 0  # micro-steps
        self.updates = 0
        self.accum = max(1, cfg.grad_accum)
        # placement (parallel.mesh.shard_state): the mesh, the mode, the specs
        self.mesh = None
        self.mode = "single"
        self.specs: Optional[Dict[str, tuple]] = None
        self.rebuild()

    def rebuild(self) -> None:
        """The optimizer, the accumulator and the EMA built anew on the
        net's current parameters (after FSDP2 has replaced them by
        sharded ones), fresh: ``load_state_dict`` puts values back."""
        cfg, net = self.cfg, self.net
        self.names = [k for k, p in net.named_parameters() if p.requires_grad]
        self.params = [p for p in net.parameters() if p.requires_grad]
        opt = torch.optim.AdamW if cfg.weight_decay else torch.optim.Adam
        kw = dict(weight_decay=cfg.weight_decay) if cfg.weight_decay else {}
        self.optimizer = opt(self.params, lr=self.schedule(0),
                             betas=(cfg.beta1, cfg.beta2), eps=cfg.eps, **kw)
        self.acc: Optional[Dict[str, torch.Tensor]] = (
            {k: torch.zeros_like(p) for k, p in net.named_parameters() if p.requires_grad}
            if self.accum > 1 else None
        )
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {k: v.detach().clone() for k, v in net.named_parameters()}
            if cfg.ema_decay else None
        )

    def _sync_grads(self) -> None:
        """Sum the plain (not sharded) gradients over the data ranks: one
        all-reduce of their concatenation."""
        if self.mesh is None:
            return
        grads = [p.grad for p in self.params if not is_sharded(p.grad)]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=pixel_group(self.mesh))
        torch._foreach_copy_(grads, [t.view_as(g) for t, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])

    def apply_gradients(self) -> None:
        """One micro-step from the grads on the trainable parameters,
        which it clears.  Every grad_accum-th micro-step (each one
        without accumulation) applies an optimizer update, then the
        EMA, on the mean gradient of those micro-steps."""
        for p in self.params:
            if p.grad is None:  # optax updates with a zero gradient
                p.grad = torch.zeros_like(p)
        self._sync_grads()
        n = self.step % self.accum  # micro-steps already in the mean
        self.step += 1
        if self.acc is not None:
            acc = [local(a) for a in self.acc.values()]
            diff = torch._foreach_sub([local(p.grad) for p in self.params], acc)
            torch._foreach_div_(diff, n + 1)
            torch._foreach_add_(acc, diff)
            self.optimizer.zero_grad(set_to_none=True)
            if n + 1 < self.accum:
                return
            for p, a in zip(self.params, self.acc.values()):
                p.grad = a  # placed as its parameter
        if self.cfg.grad_clip:
            columns = None
            if self.mode == "tp":
                dims = self._tp_dims()
                columns = (model_axis(self.mesh).group,
                           [dims.get(k) is not None for k in self.names])
            clip_by_global_norm_(self.params, self.cfg.grad_clip, columns)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.acc is not None:
            torch._foreach_zero_([local(a) for a in self.acc.values()])
        self.updates += 1
        d = self.cfg.ema_decay
        if d and self.ema is not None:
            with torch.no_grad():
                for k, p in self.net.named_parameters():
                    local(self.ema[k]).mul_(d).add_(local(p.detach()), alpha=1.0 - d)

    @property
    def sharded(self) -> bool:
        """Whether the state's tensors are split over ranks (FSDP or TP)."""
        return self.mode in ("fsdp", "tp")

    def _tp_dims(self) -> Dict[str, int]:
        """The tensor-parallel slices' dims by parameter name."""
        return {k: tp_dim(spec) for k, spec in self.specs.items()
                if tp_dim(spec) is not None}

    def _whole(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A name-keyed dict of tensor-parallel slices gathered whole."""
        dims, ax = self._tp_dims(), model_axis(self.mesh)
        return {k: tp_gather(v, dims.get(k), ax) if k in dims else v.detach().clone()
                for k, v in tree.items()}

    def _part(self, key: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's part of the single-device tensor ``full`` of
        parameter ``key``, laid out as ``like``."""
        if self.mode == "tp":
            return tp_slice(full, self._tp_dims().get(key), model_axis(self.mesh))
        return shard_of(full, like)

    def _whole_optimizer(self) -> Dict[str, Any]:
        """The optimizer's state_dict with each tensor-parallel moment
        gathered whole."""
        osd = self.optimizer.state_dict()
        dims, ax = self._tp_dims(), model_axis(self.mesh)
        state = {}
        for i, st in osd["state"].items():
            p, dim = self.params[int(i)], dims.get(self.names[int(i)])
            state[i] = {k: tp_gather(v, dim, ax) if (isinstance(v, torch.Tensor)
                                                      and v.dim() == p.dim() and dim is not None)
                        else _clone(v) for k, v in st.items()}
        return {"state": state, "param_groups": _clone(osd["param_groups"])}

    def state_dict(self, copy: bool = False) -> Dict[str, Any]:
        """Everything a resumed run needs, in the single-device layout:
        ``params`` under the flax-path keys, ``optimizer``, ``step``,
        ``updates``, and ``ema`` and ``accum`` where the run keeps them.
        References to the live tensors (``checkpoint.save_checkpoint``
        copies them) unless ``copy``; under FSDP gathered whole
        (``parallel.mesh.full_tensor``), which every rank must call."""
        if self.mode == "tp":
            out = {"params": self._whole(self.net.state_dict()),
                   "optimizer": self._whole_optimizer(),
                   "step": self.step, "updates": self.updates}
            for key, mine in (("ema", self.ema), ("accum", self.acc)):
                if mine is not None:
                    out[key] = self._whole(mine)
            return out
        if self.sharded:
            gather = functools.partial(tree_map, full_tensor)
        else:
            gather = _clone if copy else (lambda x: x)
        out = {"params": gather(self.net.state_dict()),
               "optimizer": gather(self.optimizer.state_dict()),
               "step": self.step, "updates": self.updates}
        if self.ema is not None:
            out["ema"] = gather(dict(self.ema))
        if self.acc is not None:
            out["accum"] = gather(dict(self.acc))
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a ``state_dict`` into the live parameters, EMA and
        accumulator, and load the optimizer state; everything lands on
        the net's device.  Runs outside inference mode whatever the
        caller's thread is in: an inference tensor in the optimizer
        state could not take the next update."""
        for key, mine in (("ema", self.ema), ("accum", self.acc)):
            if mine is not None and key not in sd:
                raise ValueError(f"the checkpoint holds no {key!r}, which this run keeps "
                                 "(ema_decay and grad_accum must match the saved run)")
        if self.acc is None and "accum" in sd:
            raise ValueError("the checkpoint holds gradient accumulation buffers "
                             "(grad_accum > 1); this run has grad_accum 1")
        with torch.inference_mode(False), torch.no_grad():
            if self.sharded:
                mine = self.net.state_dict()
                if set(mine) != set(sd["params"]):
                    raise ValueError("checkpoint 'params' keys differ from the net's")
                for k, t in mine.items():
                    local(t).copy_(self._part(k, sd["params"][k], t))
            else:
                self.net.load_state_dict(sd["params"], strict=True)
            for key, mine in (("ema", self.ema), ("accum", self.acc)):
                if mine is not None:
                    if set(sd[key]) != set(mine):
                        raise ValueError(f"checkpoint {key!r} keys differ from the net's")
                    for k, t in mine.items():
                        local(t).copy_(self._part(k, sd[key][k], t))
            # cloned here: a tensor read in inference mode is an inference
            # tensor, and Optimizer.load_state_dict keeps one already on
            # the right device as it is
            self.optimizer.load_state_dict(self._placed_optimizer_state(_clone(sd["optimizer"])))
        self.step = int(sd["step"])
        self.updates = int(sd["updates"])

    def _placed_optimizer_state(self, osd: Dict[str, Any]) -> Dict[str, Any]:
        """A single-device optimizer state_dict with each moment of a
        sharded parameter cut to this rank's shard, as a sharded tensor
        like the parameter."""
        if self.mode == "tp":
            dims, ax = self._tp_dims(), model_axis(self.mesh)
            for i, st in osd["state"].items():
                p, dim = self.params[int(i)], dims.get(self.names[int(i)])
                for k, v in st.items():
                    if dim is not None and isinstance(v, torch.Tensor) and v.dim() == p.dim():
                        st[k] = tp_slice(v, dim, ax).to(p.device).clone()
            return osd
        if not self.sharded:
            return osd
        from torch.distributed.tensor import DTensor

        for i, st in osd["state"].items():
            p = self.params[int(i)]
            if not is_sharded(p):
                continue
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    st[k] = DTensor.from_local(shard_of(v.to(local(p).device), p),
                                               p.device_mesh, p.placements)
        return osd
