"""Stage-1 depth-to-depth autoencoder ("D-net"), port of
``gdn_tpu/models/dtod.py``.  Its latent and decoder features guide
stage 2, so the forward exposes them."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gdn_tpu_torch.config import ModelConfig
from gdn_tpu_torch.models.decoder import Decoder
from gdn_tpu_torch.models.encoder import Encoder
from gdn_tpu_torch.models.rtod import outputs


class DtoDNet(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(1, cfg)
        self.decoder = Decoder(cfg)

    def forward(self, depth: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Args: depth (B, H, W, 1) float32, meters.  Returns the same
        dict as RtoDNet (depth is the reconstruction)."""
        # Cast before the normalize, as the JAX package does.
        x = depth.permute(0, 3, 1, 2).to(self.cfg.compute_dtype) / self.cfg.max_depth
        latent, skips = self.encoder(x)
        recon, dec_feats, depth_scales = self.decoder(latent, skips)
        return outputs(recon, latent, dec_feats, skips, depth_scales)
