"""Stage-2 RGB-to-depth guided encoder-decoder ("G-net"), port of
``gdn_tpu/models/rtod.py``.  Inference needs RGB only."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.models.decoder import Decoder
from gdn_tpu_torch.models.encoder import Encoder


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped channels_last tensor -> its (free) NHWC view."""
    return x.permute(0, 2, 3, 1)


def outputs(depth, latent, dec_feats, skips, depth_scales) -> Dict:
    """The JAX package's output dict, every map in its NHWC layout."""
    return {
        "depth": to_nhwc(depth),
        "latent": to_nhwc(latent),
        "dec_feats": [to_nhwc(f) for f in dec_feats],
        "skips": [to_nhwc(s) for s in skips],
        "depth_scales": [to_nhwc(d) for d in depth_scales],
    }


class RtoDNet(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(3, cfg)
        self.decoder = Decoder(cfg)

    def forward(self, rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Args: rgb (B, H, W, 3) float in [0, 1].

        Returns dict with depth (B, H, W, 1) fp32 / latent / dec_feats /
        skips / depth_scales, maps NHWC as in the JAX package.
        """
        # NHWC -> NCHW-shaped channels_last view (no copy when rgb is
        # contiguous).  Cast to the compute dtype BEFORE the centering,
        # as the JAX package does.
        x = rgb.permute(0, 3, 1, 2).to(self.cfg.compute_dtype) * 2.0 - 1.0
        latent, skips = self.encoder(x)
        depth, dec_feats, depth_scales = self.decoder(latent, skips)
        return outputs(depth, latent, dec_feats, skips, depth_scales)
