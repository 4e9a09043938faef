"""What the benchmark hands to the program and to the reference alike:
the weights of both nets and the inputs, all made from ``--seed`` on
the device, in a few large calls.

Weights: one normal draw a net on the card, cut into the leaves that
``reference.model.param_shapes`` lists; a kernel is that draw over the
root of its fan-in, a GroupNorm scale 1 plus a tenth of it, every other
vector a tenth of it.  The G-net holds the D-net's decoder, as stage 2
starts from stage 1's.

Training batches: a copy of the synthetic RGB-D recipe (a road-like
ramp with 6 frontal boxes; RGB a shading of depth plus texture; ~5% of
the GT masked), batch i drawn from a generator seeded by (seed, i).
Frames for serving: the same recipe's RGB as uint8.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from reference.model import param_shapes

_BOXES = 6


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit generator seed for the stream (seed, *tags)."""
    state = np.random.SeedSequence([seed % (2 ** 63), *tags]).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def make_params(cfg: Dict, in_channels: int, seed: int, tag: int,
                device) -> Dict[str, torch.Tensor]:
    """One net's float32 parameters, keyed by flax path."""
    shapes = param_shapes(cfg, in_channels)
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = int(np.prod(shape))
        v = flat[at:at + n].view(shape)
        at += n
        if len(shape) == 4:
            v = v / float(np.sqrt(shape[1] * shape[2] * shape[3]))
        elif key.endswith("scale"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[key] = v.clone()
    return out


def make_nets_params(cfg: Dict, seed: int, device):
    """(D-net params, G-net params); the G-net's decoder is the D-net's."""
    d = make_params(cfg, 1, seed, 0, device)
    g = make_params(cfg, 3, seed, 1, device)
    g.update({k: v.clone() for k, v in d.items() if k.startswith("decoder.")})
    return d, g


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def rgbd_batch(gen: torch.Generator, b: int, h: int, w: int,
               max_depth: float) -> Dict[str, torch.Tensor]:
    """{'rgb' (B,H,W,3), 'depth' (B,H,W,1), 'mask' (B,H,W,1)} float32 on
    ``gen``'s device."""
    dev = gen.device
    rows = torch.linspace(1.0, 0.12, h, device=dev).reshape(1, h, 1)
    base = rows * max_depth * _uniform(gen, (b, 1, 1), 0.6, 1.0)
    k = (b, _BOXES, 1, 1)
    cy = _uniform(gen, k, 0.2, 0.9)
    cx = _uniform(gen, k, 0.05, 0.95)
    sz = _uniform(gen, k, 0.04, 0.18)
    bd = _uniform(gen, k, 0.05, 0.7)
    yy = torch.linspace(0.0, 1.0, h, device=dev).reshape(1, 1, h, 1)
    xx = torch.linspace(0.0, 1.0, w, device=dev).reshape(1, 1, 1, w)
    inside = (torch.abs(yy - cy) < sz) & (torch.abs(xx - cx) < sz * 1.5)
    cand = torch.where(inside, bd * max_depth, torch.full_like(bd, float("inf")))
    depth = torch.clamp(torch.minimum(base, cand.amin(dim=1)), 0.5, max_depth)
    nd = depth / max_depth
    shade = 1.0 / (0.25 + 0.75 * nd)
    shade = shade / shade.max()
    tex = 0.1 * torch.randn((b, h, w), generator=gen, device=dev)
    r = torch.clamp(shade + tex, 0.0, 1.0)
    g = torch.clamp(0.8 * (1.0 - nd) + 0.2 * xx[:, 0] + tex, 0.0, 1.0)
    bl = torch.clamp(0.3 + 0.5 * nd + tex, 0.0, 1.0)
    mask = (torch.rand((b, h, w), generator=gen, device=dev) > 0.05).float()
    return {"rgb": torch.stack([r, g, bl], dim=-1), "depth": depth[..., None],
            "mask": mask[..., None]}


def train_batch(seed: int, i: int, b: int, h: int, w: int, max_depth: float,
                device) -> Dict[str, torch.Tensor]:
    """Batch ``i`` of the training stream seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 2, i))
    return rgbd_batch(gen, b, h, w, max_depth)


def train_batches(seed: int, b: int, h: int, w: int, max_depth: float,
                  device) -> Iterator[Dict[str, torch.Tensor]]:
    """The endless training stream: batch 0, 1, 2, ..."""
    i = 0
    while True:
        yield train_batch(seed, i, b, h, w, max_depth, device)
        i += 1


def frame_pool(seed: int, n: int, h: int, w: int, device, block: int = 64) -> np.ndarray:
    """(n, H, W, 3) uint8 frames on the host, drawn on ``device``."""
    out = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, block):
        gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 3, s))
        rgb = rgbd_batch(gen, min(block, n - s), h, w, 80.0)["rgb"]
        out[s:s + rgb.shape[0]] = (rgb * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
    return out
