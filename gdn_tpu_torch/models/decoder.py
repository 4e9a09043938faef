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
from gdn_tpu_torch.parallel.spatial import level_rows


class Decoder(nn.Module):
    """len(dec_channels) x2 upsampling scales with skip fusion, then the
    depth head.  Returns (depth, dec_feats, depth_scales) with dec_feats
    ordered coarse->fine.  With ``multiscale_heads`` a DepthHead
    ``head{i}`` reads each decoder scale but the finest, and
    depth_scales holds their depths coarse->fine followed by the main
    depth (the train steps supervise ``depth_scales[:-1]``); without, it
    is empty."""

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
        n = len(cfg.dec_channels)
        for i, ch in enumerate(cfg.dec_channels):
            lat = skips[len(skips) - 1 - i]
            self.add_module(f"up{i}", UpBlock(cin, ch, lat, cfg))
            if cfg.multiscale_heads and i < n - 1:
                self.add_module(f"head{i}", DepthHead(ch, cfg))
            cin = ch
        self.head = DepthHead(cin, cfg)

    def forward(
        self, latent: torch.Tensor, skips: Sequence[torch.Tensor]
    ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        c = self.cfg
        x = latent.to(c.compute_dtype)
        dec_feats, depth_scales = [], []
        n, m = len(c.dec_channels), len(skips)
        # under sp each map holds this rank's rows: the global height of
        # every level follows from the finest skip's (an even split)
        sp = getattr(self, "sp", None)
        hs = None if sp is None else level_rows(skips[0].shape[2] * sp.size, m)
        rows = None if sp is None else hs[m]
        # skips are fine->coarse; consume coarse->fine.
        for i in range(n):
            skip = skips[m - 1 - i]
            target = tuple(skip.shape[2:4]) if sp is None else (hs[m - 1 - i], skip.shape[3])
            x = getattr(self, f"up{i}")(x, target_hw=target, lateral=skip, rows=rows)
            rows = None if sp is None else target[0]
            dec_feats.append(x)
            if c.multiscale_heads and i < n - 1:
                depth_scales.append(getattr(self, f"head{i}")(x, rows))
        depth = self.head(x, rows)
        if c.multiscale_heads:
            depth_scales.append(depth)
        return depth, dec_feats, depth_scales
