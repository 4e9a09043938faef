"""Serving the G-net: fixed-batch inference with partial-batch padding,
and the deployable artifact (port of ``gdn_tpu/serving.py``).

``export_model`` writes the (B, H, W, 3) float32 -> (B, H, W, 1) depth
forward, weights inside, as one ``torch.export`` program (``.pt2``, the
counterpart of the JAX package's StableHLO bytes); ``load_model`` and
``BatchedPredictor.from_artifact`` run it in a process that imports
``torch`` and ``gdn_tpu_torch.kernels`` and nothing of
``gdn_tpu_torch.models``: the graph calls the hand-written kernels as
the registered ops of ``kernels/ops.py``, so an artifact launches the
same kernels, as many times a batch, as the checkpoint's predictor.
An artifact runs on the device it was exported on (``device``, which
stands for the JAX package's lowering ``platforms``): its weights and
the tensors its graph makes live there.  Under ``model.quant="int8"``
the calibrated scales go in with ``quant_scales`` and become buffers of
the program.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from gdn_tpu_torch import kernels
from gdn_tpu_torch.config import Config, resolve_device
from gdn_tpu_torch.utils.profiling import span


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


def _net(cfg: Config, state_dict: Dict[str, torch.Tensor], quant_scales,
         device: torch.device) -> torch.nn.Module:
    """The G-net of ``state_dict`` (and its int8 scales) on ``device``."""
    from gdn_tpu_torch.models import RtoDNet
    from gdn_tpu_torch.ops.quant import set_quant_scales

    if cfg.model.quant != "none" and quant_scales is None:
        raise ValueError("model.quant='int8' needs calibrated activation scales "
                         "(ops.quant.calibrate_quant): pass quant_scales=")
    net = RtoDNet(cfg.model)
    net.load_state_dict(state_dict, strict=True)
    if quant_scales is not None:
        set_quant_scales(net, quant_scales)
    return net.to(device).eval()


class _Depth(torch.nn.Module):
    """rgb (B, H, W, 3) float32 in [0, 1] -> depth (B, H, W, 1) float32:
    the function an artifact holds."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return self.net(rgb)["depth"]


def export_model(cfg: Config, state_dict: Dict[str, torch.Tensor], path: str,
                 batch_size: int = 1, device=None, quant_scales=None) -> None:
    """Write the forward pass, weights inside, to ``path`` (a ``.pt2`` of
    ``torch.export.save``), pinned at (batch_size, H, W, 3) float32 on
    ``device`` (CUDA unless the CPU is asked for), where it will run."""
    device = resolve_device(device)
    h, w = cfg.model.image_size
    module = _Depth(_net(cfg, state_dict, quant_scales, device))
    spec = torch.zeros((batch_size, h, w, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(module, (spec,))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.pt2"
    torch.export.save(program, tmp)
    os.replace(tmp, path)  # atomic: a reader never sees half a file


def _load(path: str):
    """(the artifact's callable, its input's placeholder value)."""
    program = torch.export.load(path)
    name = program.graph_signature.user_inputs[0]
    spec = next(n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder" and n.name == name)
    if spec.device.type == "cuda":
        kernels.load_all()
    return program.module(), spec


def load_model(path: str):
    """Load an ``export_model`` artifact; returns a callable rgb ->
    depth, run without autograd on the device it was exported on."""
    fn = _load(path)[0]

    def call(rgb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return fn(rgb)

    return call


class BatchedPredictor:
    """Fixed-batch inference with partial-batch padding.

    Pins (batch_size, H, W, 3), pads the final partial batch, strips the
    padding from the results.  Runs on ``device`` ("cuda" unless the
    caller asks for the CPU); on CUDA the port's kernel libraries are
    built and loaded here, before any worker thread calls ``predict``.
    """

    # Batches dispatched ahead of the device-to-host fetch: enough to
    # overlap host work with the device, bounded so a large request
    # cannot pile every chunk's buffers onto the device at once.
    DEPTH = 2

    def __init__(self, cfg: Config, state_dict: Dict[str, torch.Tensor],
                 batch_size: int = 8, device=None, quant_scales=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            kernels.load_all()
        self.net = _net(cfg, state_dict, quant_scales, self.device)
        self._depth = _Depth(self.net)
        h, w = cfg.model.image_size
        self._shape = (batch_size, h, w, 3)

    @classmethod
    def from_artifact(cls, path: str) -> "BatchedPredictor":
        """Serve an ``export_model`` artifact: weights, batch size and image
        size are inside it (read from its input's placeholder), so this
        needs no model code and no checkpoint; uint8 input and the u16
        wire work as for a checkpoint."""
        self = cls.__new__(cls)
        self._depth, spec = _load(path)
        self.cfg, self.net = None, None
        self._shape = tuple(spec.shape)
        self.batch_size = self._shape[0]
        self.device = spec.device
        return self

    @property
    def image_size(self):
        """(H, W) the predictor expects."""
        return self._shape[1], self._shape[2]

    def _forward(self, rgb: torch.Tensor, wire: str) -> torch.Tensor:
        depth = self._depth(_prep_rgb(rgb))[..., 0]
        return _encode_u16(depth) if wire == "u16" else depth

    def predict(self, rgbs: np.ndarray, wire: str = "f32") -> np.ndarray:
        """rgbs (N, H, W, 3) float32 [0, 1] or uint8 [0, 255] -> depths
        (N, H, W): float32 meters, or under ``wire="u16"`` uint16
        round(depth*256) counts (decode with ``astype(np.float32)/256``).
        uint8 input is decoded on the device (1/4 the upload bytes).

        Spans (``utils.profiling``): a batch's ``gdn.predict.stage`` (pad,
        pinned host copy) and ``gdn.predict.launch`` (upload, forward, the
        device-to-host copy and its event), and the call's
        ``gdn.predict.join`` (one array of all the answers)."""
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
                with span("gdn.predict.stage"):
                    chunk = rgbs[start : start + self.batch_size]
                    pad = self.batch_size - chunk.shape[0]
                    if pad:
                        chunk = np.concatenate(
                            [chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)]
                        )
                    src = torch.from_numpy(np.ascontiguousarray(chunk))
                    if cuda:
                        src = src.pin_memory()
                with span("gdn.predict.launch"):
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
        with span("gdn.predict.join"):
            return np.concatenate(out) if out else np.zeros((0,))
