"""Shared depth-domain decoder (port of ``gdn_tpu/models/decoder.py``).

Trained inside the stage-1 D-net, then transferred into the stage-2
G-net; both encoders share the ladder widths, so the decoder's
parameters are shape-identical across stages.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.models.blocks import DepthHead, UpBlock
from gdn_tpu_torch.models.encoder import skip_channels


class Decoder(nn.Module):
    """len(dec_channels) x2 upsampling scales with skip fusion, then the
    depth head.  Returns (depth, dec_feats, depth_scales) with dec_feats
    ordered coarse->fine; depth_scales stays empty (multi-scale heads
    are not ported yet, config.py refuses them)."""

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        skips = skip_channels(cfg)
        if len(cfg.dec_channels) > len(skips):
            # would wrap into negative indexing and silently re-fuse the
            # coarsest skip (wrong-resolution output)
            raise ValueError(
                f"dec_channels has {len(cfg.dec_channels)} scales but the "
                f"encoder produces only {len(skips)} skips"
            )
        cin = cfg.enc_channels[-1]
        for i, ch in enumerate(cfg.dec_channels):
            lat = skips[len(skips) - 1 - i]
            self.add_module(f"up{i}", UpBlock(cin, ch, lat, cfg))
            cin = ch
        self.head = DepthHead(cin, cfg)

    def forward(
        self, latent: torch.Tensor, skips: Sequence[torch.Tensor]
    ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        x = latent.to(self.cfg.compute_dtype)
        dec_feats = []
        # skips are fine->coarse; consume coarse->fine.
        for i in range(len(self.cfg.dec_channels)):
            skip = skips[len(skips) - 1 - i]
            x = getattr(self, f"up{i}")(
                x, target_hw=tuple(skip.shape[2:4]), lateral=skip
            )
            dec_feats.append(x)
        return self.head(x), dec_feats, []
