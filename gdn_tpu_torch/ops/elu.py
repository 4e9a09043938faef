"""ELU whose backward reads its output only (port of ``gdn_tpu/ops/elu.py``).

Autograd of ``F.elu`` keeps the pre-activation input for its backward.
ELU's derivative is a function of its output alone:

    d elu(x) / dx = 1        where x > 0   (y > 0)
                  = exp(x)   elsewhere     = y + 1   (exact identity)

and the output is kept anyway by the op that follows (a conv's weight
gradient contracts against its input), so this form keeps nothing more.
The deconv branch's bare ELU takes it when ``elu_outform_vjp`` is set.

Under no grad (serving, ``torch.export``) it is plain ``F.elu``, so no
autograd Function reaches an exported graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _EluSaveOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = F.elu(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * torch.where(y > 0, torch.ones_like(y), y + 1)


def elu_saveout(x: torch.Tensor) -> torch.Tensor:
    """ELU of x; differentiable, keeping only the output for the backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _EluSaveOut.apply(x)
    return F.elu(x)
