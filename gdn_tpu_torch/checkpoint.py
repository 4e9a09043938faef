"""Weights for the port: carried over from the JAX package, read from a
``.pth``, or drawn at random from an explicit generator.

The port's module attributes follow the flax parameter paths and its
conv kernels are OIHW, so its ``state_dict`` keys and layouts are
exactly those of ``gdn_tpu.checkpoint.params_to_torch`` (and of the
``.pth`` files ``scripts/export_torch.py`` writes).
"""

from __future__ import annotations

import math
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
