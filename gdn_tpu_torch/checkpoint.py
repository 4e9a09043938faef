"""Weights for the port: carried over from the JAX package, read from or
written to a ``.pth``, drawn at random from an explicit generator, or
moved from the stage-1 D-net's decoder into a stage-2 G-net.

The port's module attributes follow the flax parameter paths and its
conv kernels are OIHW, so its ``state_dict`` keys and layouts are
exactly those of ``gdn_tpu.checkpoint.params_to_torch`` (and of the
``.pth`` files ``scripts/export_torch.py`` writes).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

import numpy as np
import torch

from gdn_tpu_torch.config import ModelConfig


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's nested parameter dict (numpy arrays) -> the
    port's state_dict: flax path "a/b/c" becomes key "a.b.c", 4-D conv
    kernels go HWIO -> OIHW, everything else copies as float32."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
            return
        arr = np.asarray(node, dtype=np.float32)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        out[prefix] = torch.from_numpy(np.array(arr, copy=True, order="C"))

    walk(tree, "")
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` state_dict written by ``scripts/export_torch.py``
    (tensors only; nothing is unpickled beyond them)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(sd)}")
    return {k: v.float() for k, v in sd.items()}


def save_pth(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """Write a state_dict as ``load_pth`` and ``scripts/serve_torch.py
    --pth`` read it: fp32 CPU tensors under the port's (flax-path) keys,
    the format of ``scripts/export_torch.py``."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = {k: v.detach().float().cpu().contiguous() for k, v in state_dict.items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)  # atomic: a reader never sees half a file


def transfer_stage1_decoder(g_sd: Dict[str, torch.Tensor],
                            d_sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A G-net state_dict whose ``decoder.*`` entries are copies of the
    trained D-net's.  Raises when the two decoders differ in keys or
    shapes instead of training a random decoder."""
    def dec(sd):
        return {k: v for k, v in sd.items() if k.startswith("decoder.")}

    d_dec, g_dec = dec(d_sd), dec(g_sd)
    d_shapes = {k: tuple(v.shape) for k, v in d_dec.items()}
    g_shapes = {k: tuple(v.shape) for k, v in g_dec.items()}
    if d_shapes != g_shapes:
        raise ValueError(
            "stage-1 decoder is not shape-compatible with the stage-2 "
            f"decoder: {d_shapes} vs {g_shapes}")
    return {**g_sd, **{k: v.detach().clone() for k, v in d_dec.items()}}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                in_channels: int = 3) -> Dict[str, torch.Tensor]:
    """Random weights for an RtoDNet (in_channels=3) or DtoDNet (1):
    lecun-normal conv kernels (truncated normal, variance 1/fan_in, as
    flax's initializer), GN scales 1, biases 0.  The numbers are not
    flax's: a JAX key and a torch generator give different draws."""
    from gdn_tpu_torch.models import DtoDNet, RtoDNet

    net = (RtoDNet if in_channels == 3 else DtoDNet)(cfg)
    sd = {}
    for name, p in net.state_dict().items():
        leaf = name.rsplit(".", 1)[1]
        if p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            # flax truncates at 2 std of the untruncated normal and
            # rescales so the truncated draw keeps variance 1/fan_in
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(p.shape)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        elif leaf.endswith("scale"):
            t = torch.ones(p.shape)
        else:
            t = torch.zeros(p.shape)
        sd[name] = t
    return sd
