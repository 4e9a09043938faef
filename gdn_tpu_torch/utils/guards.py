"""Numerical-health guards (port of ``gdn_tpu/utils/guards.py``): NaN and
Inf detection on the training state.

``check_finite`` reduces every floating tensor of a dict (or a
state_dict, or a nested dict) to one boolean on their device, read with
one copy to the host; ``nonfinite_paths`` names the tensors that hold a
NaN or an Inf; ``assert_finite`` raises ``FloatingPointError`` with
those names; ``GuardedStep`` wraps a train step and raises as soon as a
loss term goes non-finite (every step), or a parameter does (every
``deep_every`` steps).  Each check waits for the card: it ends the
overlap of the host with the step in flight.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every floating tensor in a nested dict,
    list or tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}" if prefix else str(i))


def check_finite(tree: Any) -> torch.Tensor:
    """A bool tensor on the tensors' device: True iff every floating
    tensor of ``tree`` is entirely finite.  One concatenation and one
    reduction, whatever the number of tensors."""
    leaves = [t.detach().reshape(-1).float() for _, t in _leaves(tree)]
    if not leaves:
        return torch.tensor(True)
    return torch.isfinite(torch.cat(leaves)).all()


def nonfinite_paths(tree: Any) -> List[str]:
    """The names of the tensors of ``tree`` that hold a NaN or an Inf."""
    named = list(_leaves(tree))
    if not named:
        return []
    flags = torch.stack([torch.isfinite(t.detach()).all() for _, t in named]).cpu()
    return [name for (name, _), ok in zip(named, flags.tolist()) if not ok]


def assert_finite(tree: Any, what: str = "tree") -> None:
    if bool(check_finite(tree)):
        return
    bad = nonfinite_paths(tree)
    raise FloatingPointError(f"non-finite values in {what}: {', '.join(bad[:8])}"
                             + ("..." if len(bad) > 8 else ""))


class GuardedStep:
    """Wraps a train step ``step_fn(state, *args) -> (state, terms)``;
    checks the loss terms every call and, every ``deep_every`` calls,
    the parameters (``state.net``)."""

    def __init__(self, step_fn: Callable, deep_every: int = 0):
        self._fn = step_fn
        self._deep_every = deep_every
        self._count = 0

    def __call__(self, state, *args) -> Tuple[Any, Dict[str, torch.Tensor]]:
        new_state, terms = self._fn(state, *args)
        self._count += 1
        assert_finite(terms, f"loss terms at call {self._count}")
        if self._deep_every and self._count % self._deep_every == 0:
            assert_finite(dict(new_state.net.named_parameters()),
                          f"params at call {self._count}")
        return new_state, terms
