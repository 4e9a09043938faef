"""Train steps of both stages (port of ``gdn_tpu/train/steps.py``).

A step is forward, ``total_loss``, backward and one micro-step of the
optimizer (an update on every ``grad_accum``-th; ``TrainState``), run
eagerly.  With ``cfg.train.remat`` the trained net's forward (the D-net
in stage 1, the G-net in stage 2; not the frozen D-net of stage 2) runs
under ``torch.utils.checkpoint``: its backward recomputes the forward
instead of keeping its activations.  Batches are dicts of tensors on
the net's device:

  depth: (B, H, W, 1) float32 metric depth (GT)
  mask:  (B, H, W, 1) float32 validity
  rgb:   (B, H, W, 3) float32 in [0, 1]  (stage 2)

Each step returns the loss terms as detached 0-d tensors (reading them
waits for the card).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gdn_tpu_torch.config import Config
from gdn_tpu_torch.losses import total_loss
from gdn_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Terms = Dict[str, torch.Tensor]


def _refuse_quant(cfg: Config) -> None:
    """Post-training quantization has a zero gradient: refuse to train."""
    if cfg.model.quant != "none":
        raise ValueError(
            f"training with model.quant={cfg.model.quant!r} is not supported")


def _apply_update(state: TrainState, loss: torch.Tensor) -> None:
    loss.backward()
    state.apply_gradients()


def _maybe_remat(net: nn.Module, cfg: Config) -> Callable:
    """``net``, or with cfg.train.remat ``net`` under a non-reentrant
    checkpoint: the forward keeps only its inputs, and the backward runs
    it again (the JAX package's ``jax.checkpoint`` with the
    ``nothing_saveable`` policy)."""
    if not cfg.train.remat:
        return net
    return lambda x: checkpoint(net, x, use_reentrant=False)


def _stage1_loss(net: nn.Module, batch: Batch, cfg: Config) -> Terms:
    out = _maybe_remat(net, cfg)(batch["depth"])
    return total_loss(
        out["depth"], batch["depth"], batch["mask"], cfg.loss,
        cfg.model.max_depth, scale_preds=out["depth_scales"][:-1],
    )


def _stage2_loss(net: nn.Module, d_net: nn.Module, batch: Batch,
                 cfg: Config) -> Terms:
    """The G-net's loss with the frozen D-net's guidance targets: the
    D-net runs on GT depth without grad; the G-net's latent and decoder
    features are held against the D-net's."""
    with torch.no_grad():
        d_out = d_net(batch["depth"])
    g_out = _maybe_remat(net, cfg)(batch["rgb"])
    return total_loss(
        g_out["depth"], batch["depth"], batch["mask"], cfg.loss,
        cfg.model.max_depth,
        pred_latents=[g_out["latent"], *g_out["dec_feats"]],
        target_latents=[d_out["latent"], *d_out["dec_feats"]],
        scale_preds=g_out["depth_scales"][:-1],
    )


def _detached(terms: Terms) -> Terms:
    return {k: v.detach() for k, v in terms.items()}


def make_stage1_step(cfg: Config) -> Callable[[TrainState, Batch],
                                              Tuple[TrainState, Terms]]:
    """The stage-1 (D-net) step: step(state, batch) -> (state, terms)."""
    _refuse_quant(cfg)

    def step(state: TrainState, batch: Batch):
        terms = _stage1_loss(state.net, batch, cfg)
        _apply_update(state, terms["total"])
        return state, _detached(terms)

    return step


def make_stage2_step(cfg: Config) -> Callable[[TrainState, nn.Module, Batch],
                                              Tuple[TrainState, Terms]]:
    """The stage-2 (G-net) step: step(state, d_net, batch) -> (state,
    terms).  ``d_net`` is the frozen stage-1 DtoDNet (guidance targets);
    the G-net's decoder is frozen inside ``state`` when
    cfg.train.freeze_decoder."""
    _refuse_quant(cfg)

    def step(state: TrainState, d_net: nn.Module, batch: Batch):
        terms = _stage2_loss(state.net, d_net, batch, cfg)
        _apply_update(state, terms["total"])
        return state, _detached(terms)

    return step


def make_eval_forward(cfg: Config, net: nn.Module,
                      flip_tta: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval forward: rgb (B, H, W, 3) -> depth (B, H, W, 1) float32,
    under ``torch.inference_mode()``, with ``net``'s weights as they are
    at each call (in-training eval reads the live G-net).  The eval
    harness resizes the depth to the GT's size afterwards.

    ``flip_tta``: horizontal-flip test-time augmentation (predict on the
    image and its mirror, un-mirror, average), as ONE forward of 2B
    images."""
    if cfg.model.quant != "none":
        raise NotImplementedError(
            f"eval with model.quant={cfg.model.quant!r} is not ported to "
            "gdn_tpu_torch yet; see ROADMAP.md Queue A item 11 (int8 PTQ)")

    @torch.inference_mode()
    def forward(rgb: torch.Tensor) -> torch.Tensor:
        if not flip_tta:
            return net(rgb)["depth"].float()
        depth = net(torch.cat([rgb, rgb.flip(2)]))["depth"].float()
        b = rgb.shape[0]
        return 0.5 * (depth[:b] + depth[b:].flip(2))

    return forward
