"""Both encoder ladders of a stage-2 step as one ladder (port of
``gdn_tpu/train/fused_encoders.py``; ``TrainConfig.fused_encoders``).

The D-net's and the G-net's encoders have the same geometry past the
stem, so the fused-guidance step runs them as ONE ladder of
``groups=2`` convolutions on ``[d | g]`` channel halves: every conv,
GroupNorm and activation serves both streams in one call, and the
streams stay independent:

- a grouped conv contracts each group's input channels only;
- GroupNorm groups are contiguous channel blocks, so ``2 * groups``
  groups keep every statistic inside its own stream;
- the D stem takes the depth zero-padded from 1 to 3 channels, with its
  kernel zero-padded to match (zero weights on zero channels).

The ladder reads the two nets' own encoder parameters (no conversion,
no new checkpoint keys).  The D half is detached: gradients reach the G
weights only.  Each block's epilogue is ``models.blocks.gn_act``, so on
the card an ELU ladder launches the GroupNorm+ELU kernel at C up to 2 x
512 with 2G groups, where the JAX ladder calls the plain
``group_norm_act``.  No fused conv kernel is taken: they have no
groups, and the JAX ladder ignores the ``use_pallas_convgn*`` flags too.

On a mesh the ladder runs the G blocks' placement: under ``tp`` each
rank holds both nets' slices of every output channel set, so the grouped
conv gives [D_r | G_r] and ``parallel.tensor.paired_site`` gathers each
net's slices back in order; under ``sp`` the grouped conv and the
2G-group GroupNorm take their row forms.  Under FSDP2 each unit's
weights are read inside its forward (``parallel.mesh.unit_weights``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.models.blocks import ConvBlock, _conv, gn_act
from gdn_tpu_torch.ops.conv import CL
from gdn_tpu_torch.parallel.mesh import unit_weights
from gdn_tpu_torch.parallel.spatial import level_rows
from gdn_tpu_torch.parallel.tensor import paired_site

Weights = Dict[str, torch.Tensor]


def _paired_block(x: torch.Tensor, wd: Weights, wg: Weights, g: ConvBlock, stride: int,
                  cfg: ModelConfig, rows: Optional[int] = None, kernel_d=None) -> torch.Tensor:
    """One grouped conv of x (B, 2 * Cin, H, W) = [d | g] with the two
    blocks' kernels (``wd``, ``wg``: their weights by name), then
    GroupNorm + activation over 2 * groups groups with their
    concatenated affines -> (B, 2 * Cout, H', W').  ``g`` is the G block
    (its groups and placement); under ``sp`` x has ``rows`` global
    rows."""
    dt = cfg.compute_dtype
    tp, sp = getattr(g, "tp", None), getattr(g, "sp", None)
    kd = (wd["Conv_0.kernel"] if kernel_d is None else kernel_d).detach()
    kernel = torch.cat([kd.to(dt), wg["Conv_0.kernel"].to(dt)])
    scale = torch.cat([wd["gn_scale"].detach(), wg["gn_scale"]])
    bias = torch.cat([wd["gn_bias"].detach(), wg["gn_bias"]])
    out_rows = None if sp is None else -(-rows // stride)

    def conv(xs):
        return _conv(xs[0].to(dt), kernel, stride, sp, rows=rows, groups=2)

    def epilogue(y, s, b, groups):
        return gn_act(y, s, b, groups, cfg, sp, out_rows)

    if tp is None:
        return epilogue(conv([x]), scale, bias, 2 * g.groups)
    return paired_site(tp, conv, epilogue, x, scale, bias, 2 * g.groups)


def _sub(w: Weights, prefix: str) -> Weights:
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def encoder_weights(encoder: nn.Module) -> List[Weights]:
    """The weights of an ``Encoder``'s units (the stem, each DownBlock) by
    name, read as ``parallel.mesh.unit_weights`` reads them."""
    return [unit_weights(encoder.stem), *(unit_weights(getattr(encoder, f"down{i}"))
                                          for i in range(len(encoder.cfg.enc_channels)))]


def paired_encoders(depth_norm: torch.Tensor, rgb_centered: torch.Tensor,
                    d_encoder: nn.Module, g_encoder: nn.Module, cfg: ModelConfig,
                    d_weights: Optional[List[Weights]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                               List[torch.Tensor]]:
    """Both ladders in one.

    depth_norm: (B, 1, H, W) depth / max_depth (the D-net's input);
    rgb_centered: (B, 3, H, W) rgb * 2 - 1 (the G-net's input); NCHW,
    this rank's rows of each under ``sp``.
    d_encoder / g_encoder: the two nets' ``Encoder`` modules;
    ``d_weights``: the D encoder's ``encoder_weights`` where the caller
    read them (under FSDP2, inside the D-net's forward).
    Returns (d_latent, g_latent, d_skips, g_skips) as two ``Encoder``
    calls would, the D half detached.  The blocks must be GroupNorm ones
    (``norm="group"``; ``train.steps`` refuses the other)."""
    if d_weights is None:
        with torch.no_grad():
            d_weights = encoder_weights(d_encoder)
    wds, wgs = d_weights, encoder_weights(g_encoder)
    sp = getattr(g_encoder, "sp", None)
    n = len(cfg.enc_channels)
    hs = [None] * (n + 1) if sp is None else level_rows(rgb_centered.shape[2] * sp.size, n)
    xd = F.pad(depth_norm, (0, 0, 0, 0, 0, 2))  # 1 -> 3 channels of zeros
    x = torch.cat([xd, rgb_centered], dim=1).detach().to(cfg.compute_dtype).contiguous(
        memory_format=CL)
    wd_stem = F.pad(wds[0]["Conv_0.kernel"].detach(), (0, 0, 0, 0, 0, 2))
    x = _paired_block(x, wds[0], wgs[0], g_encoder.stem, 1, cfg, hs[0], kernel_d=wd_stem)
    skips = []
    for i in range(n):
        skips.append(x)
        gg = getattr(g_encoder, f"down{i}")
        for j, stride, rows in ((0, 2, hs[i]), (1, 1, hs[i + 1])):
            p = f"ConvBlock_{j}."
            x = _paired_block(x, _sub(wds[i + 1], p), _sub(wgs[i + 1], p),
                              getattr(gg, f"ConvBlock_{j}"), stride, cfg, rows)

    def split(t):
        c = t.shape[1] // 2
        return t[:, :c].detach(), t[:, c:]

    d_latent, g_latent = split(x)
    d_skips, g_skips = zip(*(split(s) for s in skips))
    return d_latent, g_latent, list(d_skips), list(g_skips)
