"""In-process serving of the G-net: fixed-batch inference with
partial-batch padding (port of ``gdn_tpu/serving.py::BatchedPredictor``).

The StableHLO export (``export_model``, ``load_model``,
``BatchedPredictor.from_artifact``) is not ported yet: ROADMAP Queue A
item 11.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gdn_tpu_torch.config import Config, resolve_device
from gdn_tpu_torch.kernels import groupnorm as gn_kernel
from gdn_tpu_torch.models import RtoDNet


def _prep_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """Device-side input decode: uint8 wire -> float32 [0, 1]; float
    input passes through."""
    if rgb.dtype == torch.uint8:
        return rgb.float() / 255.0
    return rgb


def _encode_u16(depth: torch.Tensor) -> torch.Tensor:
    """Device-side output encode: depth meters -> uint16 round(d*256)
    counts (the KITTI GT 16-bit-PNG encoding): half the D2H bytes of
    fp32, exact to 1/256 m."""
    return torch.clamp(torch.round(depth * 256.0), 0, 65535).to(torch.uint16)


class BatchedPredictor:
    """Fixed-batch inference with partial-batch padding.

    Pins (batch_size, H, W, 3), pads the final partial batch, strips the
    padding from the results.  Runs on ``device`` ("cuda" unless the
    caller asks for the CPU); on CUDA the GroupNorm+ELU kernel is built
    and loaded here, before any worker thread calls ``predict``.
    """

    # Batches dispatched ahead of the device-to-host fetch: enough to
    # overlap host work with the device, bounded so a large request
    # cannot pile every chunk's buffers onto the device at once.
    DEPTH = 2

    def __init__(self, cfg: Config, state_dict: Dict[str, torch.Tensor],
                 batch_size: int = 8, device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            gn_kernel.load()
        net = RtoDNet(cfg.model)
        net.load_state_dict(state_dict, strict=True)
        self.net = net.to(self.device).eval()
        h, w = cfg.model.image_size
        self._shape = (batch_size, h, w, 3)

    @property
    def image_size(self):
        """(H, W) the predictor expects."""
        return self._shape[1], self._shape[2]

    def _forward(self, rgb: torch.Tensor, wire: str) -> torch.Tensor:
        depth = self.net(_prep_rgb(rgb))["depth"][..., 0]
        return _encode_u16(depth) if wire == "u16" else depth

    def predict(self, rgbs: np.ndarray, wire: str = "f32") -> np.ndarray:
        """rgbs (N, H, W, 3) float32 [0, 1] or uint8 [0, 255] -> depths
        (N, H, W): float32 meters, or under ``wire="u16"`` uint16
        round(depth*256) counts (decode with ``astype(np.float32)/256``).
        uint8 input is decoded on the device (1/4 the upload bytes)."""
        if wire not in ("f32", "u16"):
            raise ValueError(f"unknown wire {wire!r} (f32|u16)")
        if tuple(rgbs.shape[1:]) != self._shape[1:]:
            raise ValueError(
                f"expected (N, {', '.join(map(str, self._shape[1:]))}) "
                f"input, got {tuple(rgbs.shape)}"
            )
        cuda = self.device.type == "cuda"
        pending: List = []
        out: List[np.ndarray] = []

        def fetch_one():
            host, done, pad = pending.pop(0)[:3]
            if done is not None:
                done.synchronize()
            out.append(host.numpy()[: self.batch_size - pad])

        with torch.inference_mode():
            for start in range(0, rgbs.shape[0], self.batch_size):
                chunk = rgbs[start : start + self.batch_size]
                pad = self.batch_size - chunk.shape[0]
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)]
                    )
                src = torch.from_numpy(np.ascontiguousarray(chunk))
                if cuda:
                    src = src.pin_memory()
                depth = self._forward(src.to(self.device, non_blocking=True), wire)
                if cuda:
                    host = torch.empty(depth.shape, dtype=depth.dtype,
                                       pin_memory=True)
                    host.copy_(depth, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host, done = depth, None
                # src stays referenced until its async upload has run
                pending.append((host, done, pad, src))
                if len(pending) > self.DEPTH:
                    fetch_one()
            while pending:
                fetch_one()
        return np.concatenate(out) if out else np.zeros((0,))
