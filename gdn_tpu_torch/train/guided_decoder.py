"""The shared guided-decoder pass with its own backward (port of
``gdn_tpu/train/guided_decoder.py``; ``TrainConfig.fused_guidance_vjp``).

The fused-guidance step runs the frozen decoder once on the
batch-concatenated D and G encoder outputs.  Under plain autograd the
backward then runs through the whole 2B-wide decoder, though the D half
carries no cotangent: its outputs are consumed detached.

``shared_guided_decoder`` keeps the 2B-wide forward, run without grad
and keeping nothing, and writes the backward by hand: it runs the
decoder again on the G half alone (B wide) under grad and pulls only
the G half's cotangents through it.  This is exact because the decoder
works image by image (convs and per-image GroupNorm):
``decoder(cat(d, g))[B:]`` equals ``decoder(g)``.

Caller contract (``train.steps._stage2_loss_fused`` keeps it):
  - the D-half outputs are used only detached (their cotangents are
    dropped here);
  - the decoder is frozen (``freeze_decoder``): its parameters get no
    gradient.

Cost: forward(2B) + forward(B) + input backward(B), against autograd's
forward(2B) + backward(2B).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

DecoderOut = Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]


def decode_concat(decoder: nn.Module, d_latent: torch.Tensor, g_latent: torch.Tensor,
                  d_skips: Sequence[torch.Tensor], g_skips: Sequence[torch.Tensor]
                  ) -> DecoderOut:
    """``decoder`` on the batch-concatenated (D, G) latents and skips:
    its outputs 2B wide, the D half first."""
    return decoder(torch.cat([d_latent, g_latent]),
                   [torch.cat([d, g]) for d, g in zip(d_skips, g_skips)])


class _SharedGuidedDecoder(torch.autograd.Function):
    """forward(decoder, n_skips, d_latent, g_latent, *d_skips, *g_skips)
    -> (depth, *dec_feats, *depth_scales[:-1]), each 2B wide, D half
    first (depth_scales[-1], where there is one, is depth itself).  The
    skips come flattened into the arguments: ``apply`` tracks only
    tensors passed on their own."""

    @staticmethod
    def forward(ctx, decoder, n_skips, d_latent, g_latent, *skips):
        d_skips, g_skips = skips[:n_skips], skips[n_skips:]
        depth, feats, scales = decode_concat(decoder, d_latent, g_latent, d_skips, g_skips)
        ctx.decoder, ctx.n_skips = decoder, n_skips
        ctx.save_for_backward(g_latent, *g_skips)
        ctx.set_materialize_grads(False)
        return (depth, *feats, *scales[:-1])

    @staticmethod
    def backward(ctx, *cts):
        g_latent, *g_skips = ctx.saved_tensors
        b = g_latent.shape[0]
        with torch.enable_grad():
            # the decoder's parameters do not require grad (frozen): the
            # recompute builds its graph from these leaves
            gl = g_latent.detach().requires_grad_()
            gs = [s.detach().requires_grad_() for s in g_skips]
            depth, feats, scales = ctx.decoder(gl, gs)
            pairs = [(out, ct[b:]) for out, ct in zip((depth, *feats, *scales[:-1]), cts)
                     if ct is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], [gl, *gs],
                                        [c for _, c in pairs], allow_unused=True)
        n = ctx.n_skips
        return (None, None, None, grads[0], *[None] * n, *grads[1:])


def shared_guided_decoder(decoder: nn.Module, d_latent: torch.Tensor,
                          g_latent: torch.Tensor, d_skips: Sequence[torch.Tensor],
                          g_skips: Sequence[torch.Tensor]) -> DecoderOut:
    """Decode the concatenated (D, G) batch with the frozen ``decoder``:
    (depth, dec_feats, depth_scales), 2B wide with the D half first, as
    ``decoder`` itself returns them.  Only the G inputs get gradients
    (see the module docstring)."""
    n = len(g_skips)
    if len(d_skips) != n:
        raise ValueError(f"{len(d_skips)} D skips against {n} G skips")
    if any(p.requires_grad for p in decoder.parameters()):
        raise ValueError("shared_guided_decoder needs a frozen decoder "
                         "(freeze_decoder): its parameters get no gradient here")
    out = _SharedGuidedDecoder.apply(decoder, n, d_latent, g_latent, *d_skips, *g_skips)
    n_feats = len(decoder.cfg.dec_channels)
    scales = [*out[1 + n_feats:], out[0]] if decoder.cfg.multiscale_heads else []
    return out[0], list(out[1:1 + n_feats]), scales
