"""On-device decode of the wire batch and the training augmentation
(port of ``gdn_tpu/data/augment.py``).

The host only decodes images; the augmentation is a few dozen launches
over the whole batch on its device:

- a per-sample zoom-in by s in ``scale_range`` with a random crop
  window, and a horizontal flip, as a separable warp: rows, then
  columns, each a gather along its axis (the TPU evaluates the same warp
  as two interpolation matrices on its MXU).  RGB is bilinear, depth and
  mask nearest, so values are copied and sparse LiDAR validity stays
  crisp; the zoomed depth is divided by s (a zoom-in brings the scene
  nearer), the mask is not;
- a colour jitter of brightness, contrast (about the per-image,
  per-channel mean) and saturation (about the per-pixel channel mean),
  then a clip to [0, 1].

Bilinear is clip-then-weight, as in the JAX package: c0 = clip(floor(c)),
c1 = clip(c0 + 1), w = c - c0 with the clipped c0, so a coordinate below
0 extrapolates a little.  Nearest is clip(round(c)), half to even.

The draws are separate from the warp.  ``augment_params`` draws the
seven per-sample values from an explicit CPU ``torch.Generator`` (the
pipeline seeds one a batch from (seed, batch index), so a resumed run
draws what an unbroken one would, and the card and the CPU draw the
same); ``apply_augment`` applies them on the batch's device.
"""

from __future__ import annotations

from typing import Dict

import torch

from gdn_tpu_torch.config import DataConfig

PARAMS = ("scale", "oy", "ox", "flip", "brightness", "contrast", "saturation")


def decode_wire_batch(batch: Dict[str, torch.Tensor], *, max_depth: float,
                      depth_scale: float = 256.0) -> Dict[str, torch.Tensor]:
    """Decode a wire batch on its device: uint8 RGB -> float32 *
    (1 / 255); depth counts -> float32 * (1 / depth_scale) meters, the mask
    0 < d < max_depth (so zeroed padding rows stay masked), then the
    clip to [0, max_depth].  Float leaves pass through, so an "f32"
    batch is returned as it is.

    The wire's uint16 counts travel as int16 with the same bits
    (``torch.uint16`` has no pinned memory, and gathers of it are not
    available everywhere); they are widened to int32 and masked to
    0..65535 before the float conversion."""
    out = dict(batch)
    rgb = batch["rgb"]
    # products with the reciprocal, as XLA compiles the JAX package's
    # divisions by a constant: a division differs in the last bit
    if rgb.dtype == torch.uint8:
        out["rgb"] = rgb.to(torch.float32) * (1.0 / 255.0)
    depth = batch["depth"]
    if depth.dtype in (torch.int16, torch.uint16):
        d = (depth.to(torch.int32) & 0xFFFF).to(torch.float32) * (1.0 / depth_scale)
        out["mask"] = ((d > 0.0) & (d < max_depth)).to(torch.float32)
        out["depth"] = torch.clamp(d, 0.0, max_depth)
    return out


def augment_params(gen: torch.Generator, batch_size: int,
                   cfg: DataConfig) -> Dict[str, torch.Tensor]:
    """The per-sample augmentation values, (B,) float32 on the CPU each,
    drawn from ``gen`` (a CPU generator): ``scale`` s (1 without
    random_crop), ``oy``/``ox`` the crop window's offset as fractions of
    its slack, ``flip`` 0 or 1, and the three jitter factors in
    [1 - strength, 1 + strength) (1 without color_jitter)."""
    b = batch_size

    def uniform(lo, hi):
        return torch.rand(b, generator=gen) * (hi - lo) + lo

    lo, hi = cfg.scale_range
    ones = torch.ones(b)
    s = uniform(lo, hi) if cfg.random_crop else ones
    oy, ox = torch.rand(b, generator=gen), torch.rand(b, generator=gen)
    flip = (torch.rand(b, generator=gen) < 0.5).float() if cfg.random_flip else 0 * ones
    j = cfg.jitter_strength
    jit = [uniform(1.0 - j, 1.0 + j) if cfg.color_jitter else ones for _ in range(3)]
    return dict(zip(PARAMS, (s, oy, ox, flip, *jit)))


def _coords(params, h: int, w: int):
    """(B, H) row and (B, W) column sampling coordinates, float32, in the
    JAX package's order of operations."""
    s = params["scale"][:, None]
    dev = s.device
    hf = torch.full_like(s, float(h))
    wf = torch.full_like(s, float(w))
    # tensor / tensor: a true division on every device (h / s in Python
    # would take the reciprocal and round differently)
    oy = params["oy"][:, None] * (hf - hf / s)
    ox = params["ox"][:, None] * (wf - wf / s)
    ys = oy + (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / s - 0.5
    xs = ox + (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / s - 0.5
    xs = torch.where(params["flip"][:, None] > 0, (w - 1.0) - xs, xs)
    return ys, xs


def _take(img: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """img (B, H, W, C) gathered along ``axis`` (1: rows, 2: columns) at
    per-sample indices idx (B, n)."""
    shape = list(img.shape)
    shape[axis] = idx.shape[1]
    view = (idx.shape[0], idx.shape[1], 1, 1) if axis == 1 else (idx.shape[0], 1, idx.shape[1], 1)
    return torch.gather(img, axis, idx.reshape(view).expand(shape))


def _bilinear(img: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    n = img.shape[axis]
    c0 = torch.clamp(torch.floor(coords), 0, n - 1)
    c1 = torch.clamp(c0 + 1, 0, n - 1)
    wt = coords - c0
    view = (-1, coords.shape[1], 1, 1) if axis == 1 else (-1, 1, coords.shape[1], 1)
    wt = wt.reshape(view)
    return (_take(img, c0.long(), axis) * (1.0 - wt)
            + _take(img, c1.long(), axis) * wt)


def _nearest(img: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    n = img.shape[axis]
    return _take(img, torch.clamp(torch.round(coords), 0, n - 1).long(), axis)


def apply_augment(batch: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
                  cfg: DataConfig) -> Dict[str, torch.Tensor]:
    """Augment {'rgb' (B, H, W, 3) in [0, 1], 'depth' (B, H, W, 1)
    meters, 'mask' (B, H, W, 1)} with ``params`` (``augment_params``,
    moved to the batch's device here if they are not there), on the
    batch's device.  Other keys pass through."""
    rgb, depth, mask = batch["rgb"], batch["depth"], batch["mask"]
    dev = rgb.device
    p = {k: v.to(dev, torch.float32) for k, v in params.items()}
    h, w = rgb.shape[1], rgb.shape[2]
    ys, xs = _coords(p, h, w)
    rgb = _bilinear(_bilinear(rgb, ys, 1), xs, 2)
    # depth and mask take the same nearest indices: one warp of both
    dm = _nearest(_nearest(torch.cat([depth, mask], dim=-1), ys, 1), xs, 2)
    depth = dm[..., :1] / p["scale"].reshape(-1, 1, 1, 1)
    mask = dm[..., 1:]
    if cfg.color_jitter:
        rgb = rgb * p["brightness"].reshape(-1, 1, 1, 1)
        # means as sums times the reciprocal count, as XLA compiles jnp.mean
        mean = rgb.sum(dim=(1, 2), keepdim=True) * (1.0 / (h * w))
        rgb = (rgb - mean) * p["contrast"].reshape(-1, 1, 1, 1) + mean
        gray = rgb.sum(dim=-1, keepdim=True) * (1.0 / 3.0)
        rgb = (rgb - gray) * p["saturation"].reshape(-1, 1, 1, 1) + gray
        rgb = torch.clamp(rgb, 0.0, 1.0)
    out = dict(batch)
    out.update(rgb=rgb, depth=depth, mask=mask)
    return out

