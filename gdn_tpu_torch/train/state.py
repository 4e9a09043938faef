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
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils._pytree import tree_map

from gdn_tpu_torch.config import TrainConfig

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


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the grads of ``params`` in place by max_norm / norm when
    their global norm reaches max_norm (optax's rule).  Returns the norm."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


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
        self.params = [p for p in net.parameters() if p.requires_grad]
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        opt = torch.optim.AdamW if cfg.weight_decay else torch.optim.Adam
        kw = dict(weight_decay=cfg.weight_decay) if cfg.weight_decay else {}
        self.optimizer = opt(self.params, lr=self.schedule(0),
                             betas=(cfg.beta1, cfg.beta2), eps=cfg.eps, **kw)
        self.step = 0  # micro-steps
        self.updates = 0
        self.accum = max(1, cfg.grad_accum)
        self.acc: Optional[Dict[str, torch.Tensor]] = (
            {k: torch.zeros_like(p) for k, p in net.named_parameters() if p.requires_grad}
            if self.accum > 1 else None
        )
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {k: v.detach().clone() for k, v in net.named_parameters()}
            if cfg.ema_decay else None
        )

    def apply_gradients(self) -> None:
        """One micro-step from the grads on the trainable parameters,
        which it clears.  Every grad_accum-th micro-step (each one
        without accumulation) applies an optimizer update, then the
        EMA, on the mean gradient of those micro-steps."""
        for p in self.params:
            if p.grad is None:  # optax updates with a zero gradient
                p.grad = torch.zeros_like(p)
        n = self.step % self.accum  # micro-steps already in the mean
        self.step += 1
        if self.acc is not None:
            acc = list(self.acc.values())
            diff = torch._foreach_sub([p.grad for p in self.params], acc)
            torch._foreach_div_(diff, n + 1)
            torch._foreach_add_(acc, diff)
            self.optimizer.zero_grad(set_to_none=True)
            if n + 1 < self.accum:
                return
            for p, a in zip(self.params, acc):
                p.grad = a
        if self.cfg.grad_clip:
            clip_by_global_norm_(self.params, self.cfg.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.acc is not None:
            torch._foreach_zero_(list(self.acc.values()))
        self.updates += 1
        d = self.cfg.ema_decay
        if d and self.ema is not None:
            with torch.no_grad():
                for k, p in self.net.named_parameters():
                    self.ema[k].mul_(d).add_(p.detach(), alpha=1.0 - d)

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs, as references to the live
        tensors (``checkpoint.save_checkpoint`` copies them): ``params``
        under the flax-path keys, ``optimizer``, ``step``, ``updates``,
        and ``ema`` and ``accum`` where the run keeps them."""
        out = {"params": self.net.state_dict(), "optimizer": self.optimizer.state_dict(),
               "step": self.step, "updates": self.updates}
        if self.ema is not None:
            out["ema"] = dict(self.ema)
        if self.acc is not None:
            out["accum"] = dict(self.acc)
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
            self.net.load_state_dict(sd["params"], strict=True)
            for key, mine in (("ema", self.ema), ("accum", self.acc)):
                if mine is not None:
                    if set(sd[key]) != set(mine):
                        raise ValueError(f"checkpoint {key!r} keys differ from the net's")
                    for k, t in mine.items():
                        t.copy_(sd[key][k])
            # cloned here: a tensor read in inference mode is an inference
            # tensor, and Optimizer.load_state_dict keeps one already on
            # the right device as it is
            self.optimizer.load_state_dict(tree_map(
                lambda v: v.clone() if isinstance(v, torch.Tensor) else v, sd["optimizer"]))
        self.step = int(sd["step"])
        self.updates = int(sd["updates"])
