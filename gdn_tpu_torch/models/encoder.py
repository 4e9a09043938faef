"""Shared encoder ladder used by both stages (port of
``gdn_tpu/models/encoder.py``)."""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.models.blocks import ConvBlock, DownBlock
from gdn_tpu_torch.parallel.spatial import level_rows


def skip_channels(cfg: ModelConfig) -> List[int]:
    """Channels of the encoder's skips, fine -> coarse: the stem's
    output, then each DownBlock's output but the last."""
    return [cfg.enc_channels[0], *cfg.enc_channels[:-1]]


class Encoder(nn.Module):
    """Conv ladder: 7x7 stem at full res, then len(enc_channels) /2 stages.

    Returns (latent, skips) where skips[i] is the feature map *before*
    downsampling step i (the decoder's laterals), ordered fine->coarse.
    """

    def __init__(self, in_channels: int, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBlock(in_channels, cfg.enc_channels[0], kernel=7, cfg=cfg)
        cin = cfg.enc_channels[0]
        for i, ch in enumerate(cfg.enc_channels):
            self.add_module(f"down{i}", DownBlock(cin, ch, cfg))
            cin = ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        sp = getattr(self, "sp", None)
        n = len(self.cfg.enc_channels)
        hs = [None] * (n + 1)
        if sp is not None:  # x holds this rank's rows of an even split
            hs = level_rows(x.shape[2] * sp.size, n)
        x = self.stem(x.to(self.cfg.compute_dtype), hs[0])
        skips = []
        for i in range(n):
            skips.append(x)
            x = getattr(self, f"down{i}")(x, hs[i])
        return x, skips
