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
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.models.blocks import ConvBlock, gn_act
from gdn_tpu_torch.ops.conv import CL, conv_same


def _paired_block(x: torch.Tensor, d: ConvBlock, g: ConvBlock, stride: int,
                  cfg: ModelConfig, kernel_d=None) -> torch.Tensor:
    """One grouped conv of x (B, 2 * Cin, H, W) = [d | g] with the two
    blocks' kernels, then GroupNorm + activation over 2 * groups groups
    with their concatenated affines -> (B, 2 * Cout, H', W')."""
    dt = cfg.compute_dtype
    wd = d.Conv_0.kernel.detach() if kernel_d is None else kernel_d
    kernel = torch.cat([wd.to(dt), g.Conv_0.kernel.to(dt)])
    y = conv_same(x.to(dt), kernel, stride, groups=2)
    scale = torch.cat([d.gn_scale.detach(), g.gn_scale])
    bias = torch.cat([d.gn_bias.detach(), g.gn_bias])
    return gn_act(y, scale, bias, 2 * g.groups, cfg)


def paired_encoders(depth_norm: torch.Tensor, rgb_centered: torch.Tensor,
                    d_encoder: nn.Module, g_encoder: nn.Module, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor],
                               List[torch.Tensor]]:
    """Both ladders in one.

    depth_norm: (B, 1, H, W) depth / max_depth (the D-net's input);
    rgb_centered: (B, 3, H, W) rgb * 2 - 1 (the G-net's input); NCHW.
    d_encoder / g_encoder: the two nets' ``Encoder`` modules.
    Returns (d_latent, g_latent, d_skips, g_skips) as two ``Encoder``
    calls would, the D half detached.  The blocks must be GroupNorm ones
    (``norm="group"``; ``train.steps`` refuses the other)."""
    xd = F.pad(depth_norm, (0, 0, 0, 0, 0, 2))  # 1 -> 3 channels of zeros
    x = torch.cat([xd, rgb_centered], dim=1).detach().to(cfg.compute_dtype).contiguous(
        memory_format=CL)
    wd_stem = F.pad(d_encoder.stem.Conv_0.kernel.detach(), (0, 0, 0, 0, 0, 2))
    x = _paired_block(x, d_encoder.stem, g_encoder.stem, 1, cfg, kernel_d=wd_stem)
    skips = []
    for i in range(len(cfg.enc_channels)):
        skips.append(x)
        dd, gg = getattr(d_encoder, f"down{i}"), getattr(g_encoder, f"down{i}")
        x = _paired_block(x, dd.ConvBlock_0, gg.ConvBlock_0, 2, cfg)
        x = _paired_block(x, dd.ConvBlock_1, gg.ConvBlock_1, 1, cfg)

    def split(t):
        c = t.shape[1] // 2
        return t[:, :c].detach(), t[:, c:]

    d_latent, g_latent = split(x)
    d_skips, g_skips = zip(*(split(s) for s in skips))
    return d_latent, g_latent, list(d_skips), list(g_skips)
