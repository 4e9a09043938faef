"""Train steps of both stages (port of ``gdn_tpu/train/steps.py``).

A step is forward, ``total_loss``, backward and one micro-step of the
optimizer (an update on every ``grad_accum``-th; ``TrainState``), run
eagerly.  With ``cfg.train.remat`` the trained net's forward (the D-net
in stage 1, the G-net in stage 2; not the frozen D-net of stage 2) runs
under ``torch.utils.checkpoint`` with the policy ``remat_policy`` names
(``REMAT_SAVED``): its backward recomputes what the policy does not
save.  Batches are dicts of tensors on the net's device:

  depth: (B, H, W, 1) float32 metric depth (GT)
  mask:  (B, H, W, 1) float32 validity
  rgb:   (B, H, W, 3) float32 in [0, 1]  (stage 2)

``fused_guidance`` runs stage 2 with one pass of the frozen decoder over
the D and G encoders' outputs (``_stage2_loss_fused``), through
``train.guided_decoder`` with ``fused_guidance_vjp`` and after one
paired encoder ladder (``train.fused_encoders``) with
``fused_encoders``.  That path applies no remat, as in the JAX package.
The multistep builders run ``steps_per_call`` steps a call on batches
stacked on a leading axis.

Each step returns the loss terms as detached 0-d tensors (reading them
waits for the card).  Its host time is split by the spans
``gdn.train.forward`` (the loss), ``gdn.train.backward`` and
``gdn.train.update`` (``utils.profiling.span``).

With a ``mesh`` (``parallel.mesh.create_mesh``) a step is data
parallel, as the JAX package's step on a mesh: the batch it is given is
this rank's rows of the global batch (``parallel.mesh.shard_batch``),
the loss terms are the rank's shares of the global terms
(``losses.total_loss(group=)``), the state (placed by
``parallel.mesh.shard_state``, replicated or FSDP) sums the ranks'
gradients, and the terms it returns are the global ones on every rank.
Under FSDP ``fused_guidance`` runs inside the nets' root forwards and
reads the paired ladder's weights inside their units' forwards
(``parallel.mesh.in_forward``): FSDP2 holds a unit's weights sharded
outside its forward.

On a mesh with a ``"model"`` dim (tensor parallel) every model rank runs
the same loss on the gathered outputs; on one with a ``"spatial"`` dim
each rank's batch is its image rows of its batch rows, the loss terms
take the halo forms (``losses.total_loss(rows=)``) and, as in the JAX
package (``_spatial_safe_cfg``), the fused loss kernel and the composed
resize+conv, which have no halo form, are off.  Sums of pixels run over
the ``"data"`` x ``"spatial"`` ranks (``parallel.mesh.pixel_group``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from gdn_tpu_torch.config import Config
from gdn_tpu_torch.losses import total_loss
from gdn_tpu_torch.models.rtod import to_nhwc
from gdn_tpu_torch.parallel.mesh import (
    global_sum, in_forward, pixel_group, spatial_axis, spatial_size,
)
from gdn_tpu_torch.train.fused_encoders import encoder_weights, paired_encoders
from gdn_tpu_torch.train.guided_decoder import decode_concat, shared_guided_decoder
from gdn_tpu_torch.train.state import TrainState
from gdn_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]
Terms = Dict[str, torch.Tensor]

_aten = torch.ops.aten
_DOTS = (_aten.convolution.default, _aten.mm.default, _aten.addmm.default,
         _aten.bmm.default)
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)
# remat_policy -> the ops whose outputs the checkpoint keeps (jax 0.9.0's
# policies: dots_saveable keeps dot_general and conv_general_dilated, the
# no-batch-dims one only dot_generals without batch dims, so this all-conv
# net recomputes its convs under it).  nothing_saveable keeps none (the
# plain checkpoint) and everything_saveable all (no checkpoint).  The
# kernels launch through ctypes, outside the dispatcher: no policy can
# keep their outputs, and every recompute launches them again.
REMAT_SAVED = {
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
    "everything_saveable": None,
}


def _refuse_quant(cfg: Config) -> None:
    """Post-training quantization has a zero gradient: refuse to train."""
    if cfg.model.quant != "none":
        raise ValueError(
            f"training with model.quant={cfg.model.quant!r} is not supported "
            "(post-training quantization is inference-only; train with "
            "quant='none' and quantize at deployment)")


def _spatial_safe_cfg(cfg: Config, mesh) -> Config:
    """On a spatial mesh, the loss's plain terms and the uncomposed
    resize_conv (the JAX package's ``_spatial_safe_cfg``): neither the
    fused loss kernel nor the composed op has a halo form.  Both flags
    are execution-only (same function, same parameters), so this changes
    no math.  ``cfg`` itself elsewhere."""
    if spatial_size(mesh) <= 1:
        return cfg
    if cfg.loss.use_pallas:
        cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, use_pallas=False))
    if cfg.model.resize_conv_composed:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, resize_conv_composed=False))
    return cfg


def _model_apply_override(orig: Config, safe: Config, net: nn.Module) -> None:
    """Where ``_spatial_safe_cfg`` changed the model config, the placed
    nets' blocks take the safe one (the JAX package swaps its apply_fn;
    the parameters are the same)."""
    if safe.model == orig.model or net is None:
        return
    for m in net.modules():
        if getattr(m, "cfg", None) is not None:
            m.cfg = safe.model


def _apply_update(state: TrainState, loss: torch.Tensor) -> None:
    with span("gdn.train.backward"):
        loss.backward()
    with span("gdn.train.update"):
        state.apply_gradients()


def _keep(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(net: nn.Module, cfg: Config) -> Callable:
    """``net``, or with cfg.train.remat ``net`` under a non-reentrant
    checkpoint with the policy cfg.train.remat_policy names (the JAX
    package's ``jax.checkpoint(policy=getattr(jax.checkpoint_policies,
    name))``): the forward keeps its inputs and the outputs of the ops
    the policy saves (``REMAT_SAVED``), and the backward runs the rest
    again."""
    if not cfg.train.remat:
        return net
    saved = REMAT_SAVED[cfg.train.remat_policy]
    if saved is None:
        return net
    if not saved:
        return lambda x: checkpoint(net, x, use_reentrant=False)
    context = functools.partial(create_selective_checkpoint_contexts,
                                functools.partial(_keep, saved))
    return lambda x: checkpoint(net, x, use_reentrant=False, context_fn=context)


def _stage1_loss(net: nn.Module, batch: Batch, cfg: Config, group=None,
                 rows=None) -> Terms:
    out = _maybe_remat(net, cfg)(batch["depth"])
    return total_loss(
        out["depth"], batch["depth"], batch["mask"], cfg.loss,
        cfg.model.max_depth, scale_preds=out["depth_scales"][:-1], group=group, rows=rows,
    )


def _stage2_loss(net: nn.Module, d_net: nn.Module, batch: Batch,
                 cfg: Config, group=None, rows=None) -> Terms:
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
        scale_preds=g_out["depth_scales"][:-1], group=group, rows=rows,
    )


def _stage2_loss_fused(net: nn.Module, d_net: nn.Module, batch: Batch,
                       cfg: Config, group=None, rows=None) -> Terms:
    """The stage-2 loss with ONE pass of the frozen decoder
    (``fused_guidance``): the D encoder (no grad) and the G encoder, or
    with ``fused_encoders`` one paired ladder, then the G-net's decoder
    on the batch-concatenated latents and skips, through
    ``shared_guided_decoder`` with ``fused_guidance_vjp``.  The G half
    is ``[B:]``, the detached D half ``[:B]``; the terms are the two-net
    step's (convs and GroupNorm work image by image).  The D-net's own
    decoder is not called: under ``freeze_decoder`` both nets hold the
    stage-1 decoder.  No remat on this path, as in the JAX package.
    Under FSDP2 it runs as the G-net's forward and reads the D-net inside
    the D-net's (``parallel.mesh.in_forward``), so that the roots' and
    the units' weights are whole where they are read."""
    mc = cfg.model
    b = batch["depth"].shape[0]
    depth_norm = batch["depth"].permute(0, 3, 1, 2).detach() / mc.max_depth
    rgb_centered = batch["rgb"].permute(0, 3, 1, 2) * 2.0 - 1.0

    def loss():
        with torch.no_grad():
            if cfg.train.fused_encoders:
                d_weights = in_forward(d_net, lambda: encoder_weights(d_net.encoder))
            else:
                d_latent, d_skips = in_forward(d_net, lambda: d_net.encoder(depth_norm))
        if cfg.train.fused_encoders:
            d_latent, g_latent, d_skips, g_skips = paired_encoders(
                depth_norm, rgb_centered, d_net.encoder, net.encoder, mc, d_weights)
        else:
            g_latent, g_skips = net.encoder(rgb_centered)
        decode = shared_guided_decoder if cfg.train.fused_guidance_vjp else decode_concat
        depth, feats, scales = decode(net.decoder, d_latent, g_latent, d_skips, g_skips)
        return total_loss(
            to_nhwc(depth[b:]), batch["depth"], batch["mask"], cfg.loss, mc.max_depth,
            pred_latents=[to_nhwc(g_latent), *(to_nhwc(f[b:]) for f in feats)],
            target_latents=[to_nhwc(d_latent), *(to_nhwc(f[:b].detach()) for f in feats)],
            scale_preds=[to_nhwc(p[b:]) for p in scales[:-1]], group=group, rows=rows,
        )

    return in_forward(net, loss)


def _reported(terms: Terms, group=None) -> Terms:
    """The terms detached; with a data-parallel group the global terms,
    the ranks' shares summed (one all-reduce)."""
    if group is None:
        return {k: v.detach() for k, v in terms.items()}
    total = global_sum(torch.stack([v.detach().float() for v in terms.values()]), group)
    return dict(zip(terms, total))


def _placed(state: TrainState, mesh, state_sharding, orig: Config = None,
            safe: Config = None, d_net: nn.Module = None) -> None:
    """Refuse a state the mesh step cannot train: unplaced (its
    gradients would not be summed) or placed otherwise than asked.  On a
    spatial mesh the nets take the safe model config."""
    if mesh is None:
        return
    if orig is not None:
        _model_apply_override(orig, safe, state.net)
        _model_apply_override(orig, safe, d_net)
    if state.mesh is None:
        raise ValueError("a mesh step needs a placed state: parallel.mesh.shard_state")
    if state_sharding is not None and state.specs != state_sharding:
        raise ValueError("the state's placement differs from state_sharding")


def make_stage1_step(cfg: Config, mesh=None, state_sharding=None) -> Callable[
        [TrainState, Batch], Tuple[TrainState, Terms]]:
    """The stage-1 (D-net) step: step(state, batch) -> (state, terms).
    ``mesh``: data parallel over its ``"data"`` dim, ``batch`` this
    rank's rows; ``state_sharding``: the specs ``shard_state`` returned,
    checked against the state's."""
    _refuse_quant(cfg)
    orig, cfg = cfg, _spatial_safe_cfg(cfg, mesh)
    group, rows = pixel_group(mesh), spatial_axis(mesh)

    def step(state: TrainState, batch: Batch):
        _placed(state, mesh, state_sharding, orig, cfg)
        with span("gdn.train.forward"):
            terms = _stage1_loss(state.net, batch, cfg, group, rows)
        _apply_update(state, terms["total"])
        return state, _reported(terms, group)

    return step


def _stage2_loss_fn(cfg: Config) -> Callable:
    """``_stage2_loss`` or, with fused_guidance, ``_stage2_loss_fused``;
    refuses the combinations the JAX package asserts against."""
    t = cfg.train
    if t.fused_encoders and not t.fused_guidance:
        raise ValueError("fused_encoders requires fused_guidance (it feeds the "
                         "shared decoder pass)")
    if not t.fused_guidance:
        return _stage2_loss
    if not t.freeze_decoder:
        raise ValueError("fused_guidance requires freeze_decoder: the shared-decoder "
                         "pass is only valid while both nets' decoder params stay equal")
    if t.fused_encoders and cfg.model.norm != "group":
        raise ValueError("fused_encoders pairs GroupNorm blocks: it needs "
                         f"model.norm='group', not {cfg.model.norm!r}")
    return _stage2_loss_fused


def make_stage2_step(cfg: Config, mesh=None, state_sharding=None) -> Callable[
        [TrainState, nn.Module, Batch], Tuple[TrainState, Terms]]:
    """The stage-2 (G-net) step: step(state, d_net, batch) -> (state,
    terms).  ``d_net`` is the frozen stage-1 DtoDNet (guidance targets);
    the G-net's decoder is frozen inside ``state`` when
    cfg.train.freeze_decoder.  With cfg.train.fused_guidance the decoder
    runs once on both nets' encodings (``_stage2_loss_fused``).
    ``mesh``, ``state_sharding``: as in :func:`make_stage1_step`; the
    D-net is placed as the state (``parallel.mesh.shard_frozen``)."""
    _refuse_quant(cfg)
    loss_fn = _stage2_loss_fn(cfg)
    orig, cfg = cfg, _spatial_safe_cfg(cfg, mesh)
    group, rows = pixel_group(mesh), spatial_axis(mesh)

    def step(state: TrainState, d_net: nn.Module, batch: Batch):
        _placed(state, mesh, state_sharding, orig, cfg, d_net)
        with span("gdn.train.forward"):
            terms = loss_fn(state.net, d_net, batch, cfg, group, rows)
        _apply_update(state, terms["total"])
        return state, _reported(terms, group)

    return step


def _unstack(batches: Batch, steps_per_call: int):
    """The ``steps_per_call`` batches of a stacked {k: (K, B, ...)}."""
    k = next(iter(batches.values())).shape[0]
    if k != steps_per_call:
        raise ValueError(f"stacked batch has {k} steps, expected "
                         f"steps_per_call={steps_per_call}")
    return [{key: v[i] for key, v in batches.items()} for i in range(k)]


def make_stage1_multistep(cfg: Config, steps_per_call: int, mesh=None,
                          state_sharding=None) -> Callable[
        [TrainState, Batch], Tuple[TrainState, Terms]]:
    """``steps_per_call`` stage-1 steps a call: step(state, batches) ->
    (state, the last step's terms), batches stacked {k: (K, B, ...)}.
    Each step is one micro-step of ``state``, in order, so grad_accum
    and the EMA run as in K calls of ``make_stage1_step``'s step (the
    JAX package's ``jax.lax.scan``).  With a ``mesh``, ``batches`` are
    this rank's rows of each step's batch (dim 1)."""
    single = make_stage1_step(cfg, mesh, state_sharding)

    def step(state: TrainState, batches: Batch):
        for batch in _unstack(batches, steps_per_call):
            state, terms = single(state, batch)
        return state, terms

    return step


def make_stage2_multistep(cfg: Config, steps_per_call: int, mesh=None,
                          state_sharding=None) -> Callable[
        [TrainState, nn.Module, Batch], Tuple[TrainState, Terms]]:
    """``steps_per_call`` stage-2 steps a call: step(state, d_net,
    batches) -> (state, the last step's terms); see
    ``make_stage1_multistep``."""
    single = make_stage2_step(cfg, mesh, state_sharding)

    def step(state: TrainState, d_net: nn.Module, batches: Batch):
        for batch in _unstack(batches, steps_per_call):
            state, terms = single(state, d_net, batch)
        return state, terms

    return step


def make_eval_forward(cfg: Config, net: nn.Module, flip_tta: bool = False,
                      quant_scales=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval forward: rgb (B, H, W, 3) -> depth (B, H, W, 1) float32,
    under ``torch.inference_mode()``, with ``net``'s weights as they are
    at each call (in-training eval reads the live G-net).  The eval
    harness resizes the depth to the GT's size afterwards.

    ``flip_tta``: horizontal-flip test-time augmentation (predict on the
    image and its mirror, un-mirror, average), as ONE forward of 2B
    images.  Under ``model.quant="int8"`` ``net`` is the int8 G-net and
    ``quant_scales`` its calibrated activation scales
    (``ops.quant.calibrate_quant``), set into it here; without them this
    raises."""
    if cfg.model.quant != "none":
        if quant_scales is None:
            raise ValueError(
                "model.quant='int8' needs calibrated activation scales: pass "
                "quant_scales=ops.quant.calibrate_quant(net, batches)")
        from gdn_tpu_torch.ops.quant import set_quant_scales

        set_quant_scales(net, quant_scales)

    @torch.inference_mode()
    def forward(rgb: torch.Tensor) -> torch.Tensor:
        if not flip_tta:
            return net(rgb)["depth"].float()
        depth = net(torch.cat([rgb, rgb.flip(2)]))["depth"].float()
        b = rgb.shape[0]
        return 0.5 * (depth[:b] + depth[b:].flip(2))

    return forward
