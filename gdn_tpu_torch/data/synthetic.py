"""Synthetic RGB-D batches (port of ``gdn_tpu/data/synthetic.py``): a
zero-IO training source and eval split with a learnable RGB <-> depth
relation, drawn from an explicit ``torch.Generator`` (the training
batches on the device, the eval split on the host).

Depth is a road-like vertical ramp (far at the top) with 6 random
frontal boxes per image; RGB is a shading of that depth plus texture
noise; the mask drops ~5% of pixels, like sparse LiDAR GT.  Same recipe
as the JAX package; the numbers differ (a torch generator is not a JAX
key).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from gdn_tpu_torch.config import resolve_device

_BOXES = 6


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def synthetic_batch(gen: torch.Generator, batch_size: int = 4, height: int = 128,
                    width: int = 416, max_depth: float = 80.0) -> Dict[str, torch.Tensor]:
    """One batch {'rgb' (B,H,W,3), 'depth' (B,H,W,1), 'mask' (B,H,W,1)},
    float32, on ``gen``'s device."""
    b, h, w, dev = batch_size, height, width, gen.device
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
    # the nearest box wins where boxes overlap
    cand = torch.where(inside, bd * max_depth, torch.full_like(bd, float("inf")))
    depth = torch.clamp(torch.minimum(base, cand.amin(dim=1)), 0.5, max_depth)

    nd = depth / max_depth
    shade = 1.0 / (0.25 + 0.75 * nd)  # near = bright
    shade = shade / shade.max()
    tex = 0.1 * torch.randn((b, h, w), generator=gen, device=dev)
    r = torch.clamp(shade + tex, 0.0, 1.0)
    g = torch.clamp(0.8 * (1.0 - nd) + 0.2 * xx[:, 0] + tex, 0.0, 1.0)
    bl = torch.clamp(0.3 + 0.5 * nd + tex, 0.0, 1.0)
    mask = (torch.rand((b, h, w), generator=gen, device=dev) > 0.05).float()
    return {
        "rgb": torch.stack([r, g, bl], dim=-1),
        "depth": depth[..., None],
        "mask": mask[..., None],
    }


def _image_seed(seed: int, i: int) -> int:
    """The generator seed of item ``i`` of a stream seeded ``seed``."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])


class SyntheticDataset:
    """Endless iterator of synthetic batches on ``device`` (CUDA unless
    the caller asks for another; raises without a card).  Batch i is
    drawn from a generator seeded by (seed, i), so ``seek`` is O(1)."""

    def __init__(self, batch_size: int = 4, height: int = 128, width: int = 416,
                 max_depth: float = 80.0, seed: int = 0, device=None):
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.max_depth = max_depth
        self.seed = seed
        self.device = resolve_device(device)
        self._skip = 0

    def seek(self, n_batches: int) -> None:
        """Start the next iteration at batch ``n_batches``."""
        self._skip = int(n_batches)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        i, self._skip = self._skip, 0
        gen = torch.Generator(device=self.device)
        while True:
            gen.manual_seed(_image_seed(self.seed, i))
            yield synthetic_batch(gen, self.batch_size, self.height, self.width,
                                  self.max_depth)
            i += 1


class SyntheticEvalDataset:
    """A bounded eval split without data on disk: yields ``n_images``
    per-image {'rgb' (1, H, W, 3), 'gt' (1, H, W)} numpy float32 arrays
    (GT at the train size), the interface of the KITTI/NYU eval loaders.
    Image i is drawn on the host from a CPU generator seeded by (seed, i):
    the split is the same on every device (as a JAX key's draws are) and
    on every iteration.  A CUDA generator would draw another split."""

    def __init__(self, n_images: int = 32, height: int = 128, width: int = 416,
                 max_depth: float = 80.0, seed: int = 999):
        self.n_images = n_images
        self.height = height
        self.width = width
        self.max_depth = max_depth
        self.seed = seed

    def __len__(self) -> int:
        return self.n_images

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        gen = torch.Generator()
        for i in range(self.n_images):
            gen.manual_seed(_image_seed(self.seed, i))
            b = synthetic_batch(gen, 1, self.height, self.width, self.max_depth)
            yield {"rgb": b["rgb"].numpy(), "gt": b["depth"][..., 0].numpy()}
