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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

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
    steps_per_epoch)), "cosine" to 0 over the run, or "constant"; after
    a linear 0 -> lr warmup of cfg.warmup_steps updates when set."""
    warmup = max(1, cfg.warmup_steps) if cfg.warmup_steps else 0
    if cfg.schedule == "step":
        decay = _exponential_staircase(
            cfg.lr, max(1, cfg.decay_epochs * steps_per_epoch), cfg.decay_gamma)
    elif cfg.schedule == "cosine":
        decay = _cosine(cfg.lr, max(1, max(1, cfg.epochs * steps_per_epoch) - warmup))
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
    schedule, the update count and the optional EMA of every parameter.

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
        self.step = 0
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {k: v.detach().clone() for k, v in net.named_parameters()}
            if cfg.ema_decay else None
        )

    def apply_gradients(self) -> None:
        """One optimizer update from the grads on the trainable
        parameters, then the EMA; clears the grads."""
        for p in self.params:
            if p.grad is None:  # optax updates with a zero gradient
                p.grad = torch.zeros_like(p)
        if self.cfg.grad_clip:
            clip_by_global_norm_(self.params, self.cfg.grad_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        d = self.cfg.ema_decay
        if d and self.ema is not None:
            with torch.no_grad():
                for k, p in self.net.named_parameters():
                    self.ema[k].mul_(d).add_(p.detach(), alpha=1.0 - d)
