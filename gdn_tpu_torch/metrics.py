"""Depth metrics and the KITTI/NYU eval protocol (port of
``gdn_tpu/metrics.py``).

The seven standard depth metrics (AbsRel, SqRel, RMSE, RMSElog,
δ<1.25^{1,2,3}) plus log10, the depth caps and the eigen/garg crops, in
float32 with an explicit validity mask (no boolean indexing), so that a
batch of images is scored in one pass: every function reduces over the
last two axes, so (Hg, Wg) maps give scalars and (B, Hg, Wg) maps give
(B,) columns, one per image.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

METRIC_NAMES = (
    "abs_rel",
    "sq_rel",
    "rmse",
    "rmse_log",
    "log10",
    "a1",
    "a2",
    "a3",
)

_HW = (-2, -1)


def compute_errors(gt: torch.Tensor, pred: torch.Tensor,
                   mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The metrics of (..., H, W) maps over their valid pixels.

    ``pred`` must already be clipped to the evaluation range
    (:func:`apply_cap`); ``mask`` is bool or float, 1 = evaluate.  Masked
    pixels take the safe value 1.0 before any log or division, and an
    empty mask divides by 1."""
    gt = gt.float()
    pred = pred.float()
    mask = mask.float()
    n = torch.clamp(mask.sum(_HW), min=1.0)

    valid = mask > 0
    safe_gt = torch.where(valid, gt, 1.0)
    safe_pred = torch.where(valid, pred, 1.0)

    thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
    a1 = ((thresh < 1.25) * mask).sum(_HW) / n
    a2 = ((thresh < 1.25**2) * mask).sum(_HW) / n
    a3 = ((thresh < 1.25**3) * mask).sum(_HW) / n

    diff = (safe_gt - safe_pred) * mask
    abs_rel = (torch.abs(diff) / safe_gt * mask).sum(_HW) / n
    sq_rel = (diff**2 / safe_gt * mask).sum(_HW) / n
    rmse = torch.sqrt((diff**2).sum(_HW) / n)
    log_diff = (torch.log(safe_gt) - torch.log(safe_pred)) * mask
    rmse_log = torch.sqrt((log_diff**2).sum(_HW) / n)
    log10 = (torch.abs(torch.log10(safe_gt) - torch.log10(safe_pred))
             * mask).sum(_HW) / n

    return {
        "abs_rel": abs_rel,
        "sq_rel": sq_rel,
        "rmse": rmse,
        "rmse_log": rmse_log,
        "log10": log10,
        "a1": a1,
        "a2": a2,
        "a3": a3,
    }


def apply_cap(gt: torch.Tensor, pred: torch.Tensor, min_depth: float = 1e-3,
              max_depth: float = 80.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GT outside (min_depth, max_depth) leaves the mask; pred is clipped
    into [min_depth, max_depth].  Returns (gt, clipped_pred, range_mask)."""
    mask = (gt > min_depth) & (gt < max_depth)
    return gt, torch.clamp(pred, min_depth, max_depth), mask


# The published Eigen-split crop fractions (Eigen NIPS'14, Garg ECCV'16),
# applied to the GT-resolution image.
GARG_CROP_FRACTIONS = (0.40810811, 0.99189189, 0.03594771, 0.96405229)
EIGEN_CROP_FRACTIONS = (0.3324324, 0.91351351, 0.0359477, 0.96405229)


def crop_mask(height: int, width: int, crop: str = "garg") -> np.ndarray:
    """Boolean (H, W) numpy mask of the eigen/garg crop region (``none``:
    every pixel).  The bounds are ``int(fraction * size)``."""
    if crop == "none":
        return np.ones((height, width), dtype=bool)
    if crop == "garg":
        fr = GARG_CROP_FRACTIONS
    elif crop == "eigen":
        fr = EIGEN_CROP_FRACTIONS
    else:
        raise ValueError(f"unknown crop {crop!r}")
    y0, y1 = int(fr[0] * height), int(fr[1] * height)
    x0, x1 = int(fr[2] * width), int(fr[3] * width)
    m = np.zeros((height, width), dtype=bool)
    m[y0:y1, x0:x1] = True
    return m


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x`` over the ``mask`` pixels of each (H, W) map:
    masked pixels go to +inf before the sort, and an even count takes
    the lower-middle element, at index (count - 1) // 2."""
    m = mask.flatten(-2).bool()
    flat = torch.where(m, x.flatten(-2), float("inf"))
    order = torch.sort(flat, dim=-1).values
    idx = torch.clamp(m.sum(-1) - 1, min=0) // 2
    return torch.gather(order, -1, idx.unsqueeze(-1)).squeeze(-1)


def median_scale(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 min_depth: float, cap: float) -> torch.Tensor:
    """Median-scaling protocol: scale pred so the masked medians match,
    then clip.

    ``pred`` must be the RAW (unclipped) prediction: the ratio is taken
    on raw values and the clip comes after the scaling.  An empty mask or
    a pred median <= 1e-8 gives scale 1."""
    count = mask.flatten(-2).sum(-1)
    med_pred = masked_median(pred, mask)
    scale = torch.where(
        (count > 0) & (med_pred > 1e-8),
        masked_median(gt, mask) / torch.clamp(med_pred, min=1e-8),
        torch.ones_like(med_pred),
    )
    return torch.clamp(pred * scale[..., None, None], min_depth, cap)


def evaluate_prediction(gt: torch.Tensor, pred: torch.Tensor, cap: float = 80.0,
                        min_depth: float = 1e-3, crop: str = "garg",
                        median_scaling: bool = False) -> Dict[str, torch.Tensor]:
    """The eval protocol of (..., Hg, Wg) maps: crop -> cap/mask ->
    metrics.  ``pred`` must already be resized to the GT's size."""
    cmask = torch.from_numpy(crop_mask(gt.shape[-2], gt.shape[-1], crop)).to(gt.device)
    gt_, pred_, range_mask = apply_cap(gt, pred, min_depth, cap)
    mask = range_mask & cmask
    if median_scaling:
        # scale the RAW pred (apply_cap clips; see median_scale)
        pred_ = median_scale(pred, gt_, mask, min_depth, cap)
    return compute_errors(gt_, pred_, mask)


class MetricAccumulator:
    """Running mean of per-image metric dicts (host side, Python floats,
    summed in update order)."""

    def __init__(self):
        self._sums = {k: 0.0 for k in METRIC_NAMES}
        self.count = 0

    def update(self, metrics: Dict[str, float]) -> None:
        for k in METRIC_NAMES:
            self._sums[k] += float(metrics[k])
        self.count += 1

    def result(self) -> Dict[str, float]:
        n = max(self.count, 1)
        return {k: v / n for k, v in self._sums.items()}

    def table(self) -> str:
        r = self.result()
        header = " | ".join(f"{k:>8s}" for k in METRIC_NAMES)
        row = " | ".join(f"{r[k]:8.4f}" for k in METRIC_NAMES)
        return f"{header}\n{row}"
