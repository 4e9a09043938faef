"""Training losses of the two-stage guided depth pipeline (port of
``gdn_tpu/losses.py``): masked L1, the multi-scale gradient L1, SSIM and
the stage-2 latent feature matching, composed by ``total_loss``.

``LossConfig.use_pallas`` picks the route, on any device: set, recon +
the scale-0 gradient + SSIM come from ``kernels/fused_loss.py`` (the
CUDA kernels for CUDA tensors, their plain version for CPU tensors) and
the coarser gradient scales stay here; unset, every term is the plain
PyTorch below.  The coarse heads' term (``multiscale_depth_loss``) is
plain on either route, as in the JAX package.  Maps are (B, H, W) or
(B, H, W, 1).

Data parallel (``group``, the process group of the mesh's ``"data"``
dim): each rank holds its rows of the global batch, and every term is
that rank's SHARE of the global term, so the shares over the ranks add
up to the JAX package's value on the whole batch.  A term normalized by
a count (valid pixels, valid gradient pairs, valid images) divides the
rank's numerator by the count summed over the ranks
(``parallel.mesh.global_sum``: detached, the counts come from GT only);
a mean over equal-size shards (``latent_loss``, the SSIM of unweighted
images) and a constant divide by the number of ranks.  The mean of
per-rank ratios would not be the global ratio: sparse GT gives the
ranks different valid counts.

Spatial parallelism (``rows``, the mesh's ``"spatial"`` axis, with
``group`` its ``"data"`` x ``"spatial"`` ranks): the maps are this
rank's rows of each image (an even split of the input height).  Counts
are taken over ``group`` as above; the forward differences take one row
from the rank below (``_grads``), SSIM its window's halo (``ops.ssim``),
the coarse scales pool each shard, and an image counts as valid by its
mask over all its rows.  Where a shard is too thin for SSIM's window or
does not pool ``grad_scales - 1`` times, that term runs on the gathered
image on every rank (``parallel.spatial.gather_rows``): its counts,
summed over ``group``, are then S times the image's, so each rank's
term is its 1/S share and the gather's backward sums the shares.  The
latent term divides by the elements summed over ``group`` (the decoder's
levels split unevenly), and the coarse heads (uneven rows too) are
held against GT and mask picked on the whole image and cut to the
head's rows.  The fused loss kernel has no halo form: the steps route a
spatial mesh to the plain terms, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from gdn_tpu_torch.config import LossConfig
from gdn_tpu_torch.kernels.fused_loss import fused_loss_terms
from gdn_tpu_torch.ops.resize import resize_nearest
from gdn_tpu_torch.ops.ssim import ssim
from gdn_tpu_torch.parallel.mesh import global_sum, group_size
from gdn_tpu_torch.parallel.spatial import (
    gather_rows, global_rows, halo, pools_local, row_bounds, ssim_local,
)


def _squeeze(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.dim() == 4 else x


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of (B, H, W); truncates an odd trailing row/col."""
    b, h, w = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, : h2 * 2, : w2 * 2].reshape(b, h2, 2, w2, 2).mean(dim=(2, 4))


def masked_l1(pred, gt, mask, group=None) -> torch.Tensor:
    """Mean |pred - gt| over valid pixels (of the global batch)."""
    mask = mask.float()
    diff = torch.abs(pred.float() - gt.float()) * mask
    return diff.sum() / torch.clamp(global_sum(mask.sum(), group), min=1.0)


def _grads(x: torch.Tensor, rows=None):
    """Forward-difference spatial gradients of (B, H, W); with ``rows``
    x is this rank's rows and the last one's pair is the next rank's
    first row (none below the image's last)."""
    xv = x if rows is None else halo(x, 0, 1, rows, "none", dim=1)
    return x[:, :, 1:] - x[:, :, :-1], xv[:, 1:, :] - xv[:, :-1, :]


def _gradient_scale_losses(pred, gt, mask, num_scales: int,
                           skip_first: bool = False, group=None, rows=None):
    """Per-scale gradient L1 terms (a list of scalars), fine to coarse.
    With ``skip_first`` the scale-0 term (the fused kernel's) is left
    out; the pooling chain is the same either way.  A coarse pixel is
    valid only where all 4 children are (see the JAX package)."""
    terms = []
    if rows is not None and not pools_local(pred.shape[1] * rows.size, num_scales, rows.size):
        pred, gt, mask = (gather_rows(t, rows, dim=1) for t in (pred, gt, mask))
        rows = None
    for s in range(num_scales):
        if s > 0:
            pred = _avgpool2(pred)
            gt_w = _avgpool2(gt * mask)
            m_w = _avgpool2(mask)
            gt = gt_w / torch.clamp(m_w, min=1e-6)
            mask = (m_w > 0.999).float()
        if s == 0 and skip_first:
            continue
        pdx, pdy = _grads(pred, rows)
        gdx, gdy = _grads(gt, rows)
        mv = mask if rows is None else halo(mask, 0, 1, rows, "none", dim=1)
        mdx = mask[:, :, 1:] * mask[:, :, :-1]
        mdy = mv[:, 1:, :] * mv[:, :-1, :]
        counts = global_sum(torch.stack([mdx.sum(), mdy.sum()]), group)
        nx = torch.clamp(counts[0], min=1.0)
        ny = torch.clamp(counts[1], min=1.0)
        terms.append((torch.abs(pdx - gdx) * mdx).sum() / nx
                     + (torch.abs(pdy - gdy) * mdy).sum() / ny)
    return terms


def gradient_loss(pred, gt, mask, num_scales: int = 4, group=None,
                  rows=None) -> torch.Tensor:
    """Multi-scale L1 on spatial gradients of pred vs gt."""
    pred = _squeeze(pred).float()
    gt = _squeeze(gt).float()
    mask = _squeeze(mask).float()
    return sum(_gradient_scale_losses(pred, gt, mask, num_scales,
                                      group=group, rows=rows)) / num_scales


def ssim_loss(pred, gt, max_depth: float, window: int = 11, sigma: float = 1.5,
              precision: str = "highest",
              image_weights: Optional[torch.Tensor] = None, group=None,
              rows=None) -> torch.Tensor:
    """(1 - SSIM) / 2 on depth normalized by max_depth; ``image_weights``
    (B,) drops whole images (all-masked ones) from the mean."""
    p = _squeeze(pred).float() / max_depth
    g = _squeeze(gt).float() / max_depth
    if rows is not None and not ssim_local(p.shape[1] * rows.size, window, rows.size):
        p, g = gather_rows(p, rows, dim=1), gather_rows(g, rows, dim=1)
        rows = None
    s_map = ssim(p, g, max_val=1.0, window=window, sigma=sigma,
                 precision=precision, mean=False, rows=rows)
    d = group_size(group)
    if image_weights is None:
        s = s_map.mean() / d
    else:
        w = image_weights.float()
        s = (s_map.mean(dim=(1, 2)) * w).sum() / torch.clamp(global_sum(w.sum(), group),
                                                              min=1.0)
    return (1.0 / d - s) / 2.0


def multiscale_depth_loss(scale_preds: Sequence[torch.Tensor], gt: torch.Tensor,
                          mask: torch.Tensor, group=None, rows=None) -> torch.Tensor:
    """Masked L1 supervision of the coarse decoder heads
    (``ModelConfig.multiscale_heads``).  ``scale_preds`` are ordered
    coarse->fine; scale j of n weighs 0.5^(n-1-j), and the weights are
    normalized by their sum.  GT and mask go to each head's size by
    ``ops.resize.resize_nearest`` (the JAX package's half-pixel nearest,
    which keeps sparse validity; ``F.interpolate`` picks other pixels).
    With ``rows`` the maps are this rank's rows: GT and mask are
    gathered whole (no gradient), picked at each head's global size and
    cut to the head's rows."""
    gt4 = _squeeze(gt).float()[:, None]
    m4 = _squeeze(mask).float()[:, None]
    if rows is not None:
        with torch.no_grad():
            gt4, m4 = gather_rows(gt4, rows), gather_rows(m4, rows)
    n = len(scale_preds)
    total = gt4.new_zeros(())
    wsum = 0.0
    for j, p in enumerate(scale_preds):
        p3 = _squeeze(p).float()
        hw = tuple(p3.shape[1:3])
        if rows is not None:
            hw = (global_rows(p3, rows, dim=1), hw[1])
        g = resize_nearest(gt4, hw)[:, 0]
        m = resize_nearest(m4, hw)[:, 0]
        if rows is not None:
            s, e = row_bounds(hw[0], rows)
            g, m = g[:, s:e], m[:, s:e]
        w = 0.5 ** (n - 1 - j)
        total = total + w * masked_l1(p3, g, m, group)
        wsum += w
    return total / wsum


def latent_loss(feats_a: Sequence[torch.Tensor],
                feats_b: Sequence[torch.Tensor], group=None, rows=None) -> torch.Tensor:
    """Guidance feature matching: mean L1 between feature pyramids;
    ``feats_b`` is the (no-grad) target.  With ``rows`` (shards of
    unequal height) each mean divides by the elements summed over
    ``group``."""
    if len(feats_a) != len(feats_b):
        raise ValueError(
            f"feature pyramids differ in depth: {len(feats_a)} vs {len(feats_b)}")
    total = 0.0
    if rows is not None:
        counts = global_sum(torch.tensor([float(a.numel()) for a in feats_a],
                                         device=feats_a[0].device), group)
        for a, b, n in zip(feats_a, feats_b, counts):
            total = total + torch.abs(a.float() - b.float()).sum() / n
        return total / max(len(feats_a), 1)
    for a, b in zip(feats_a, feats_b):
        total = total + torch.abs(a.float() - b.float()).mean()
    return total / max(len(feats_a), 1) / group_size(group)


def total_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor,
    cfg: LossConfig,
    max_depth: float,
    pred_latents: Sequence[torch.Tensor] = (),
    target_latents: Sequence[torch.Tensor] = (),
    scale_preds: Sequence[torch.Tensor] = (),
    group=None,
    rows=None,
) -> Dict[str, torch.Tensor]:
    """Composite loss: a dict with 'total' and each term; ``scale_preds``
    (the coarse heads' depths, coarse->fine) add ``scales``.  With
    ``group`` each term is this rank's share of the global one; with
    ``rows`` the maps are this rank's rows of each image."""
    if rows is not None and cfg.use_pallas:
        raise ValueError("on a spatial mesh the loss takes the plain terms (train.steps "
                         "routes it so)")
    if cfg.use_pallas:
        fused = fused_loss_terms(pred, gt, mask, max_depth, cfg.ssim_window,
                                 cfg.ssim_sigma, precision=cfg.ssim_precision, group=group)
        coarse = _gradient_scale_losses(
            _squeeze(pred).float(), _squeeze(gt).float(), _squeeze(mask).float(),
            cfg.grad_scales, skip_first=True, group=group)
        terms = {
            "recon": fused["recon"],
            "grad": (fused["grad0"] + sum(coarse)) / cfg.grad_scales,
            "ssim": fused["ssim"],
        }
    else:
        per_image = _squeeze(mask).float().sum(dim=(1, 2))
        if rows is not None:
            per_image = global_sum(per_image, rows.group)
        valid = (per_image > 0).float()
        terms = {
            "recon": masked_l1(pred, gt, mask, group),
            "grad": gradient_loss(pred, gt, mask, cfg.grad_scales, group, rows),
            "ssim": ssim_loss(pred, gt, max_depth, cfg.ssim_window,
                              cfg.ssim_sigma, precision=cfg.ssim_precision,
                              image_weights=valid, group=group, rows=rows),
        }
    total = (cfg.w_recon * terms["recon"] + cfg.w_grad * terms["grad"]
             + cfg.w_ssim * terms["ssim"])
    if pred_latents and target_latents:
        terms["latent"] = latent_loss(pred_latents, target_latents, group, rows)
        total = total + cfg.w_latent * terms["latent"]
    if scale_preds:
        terms["scales"] = multiscale_depth_loss(scale_preds, gt, mask, group, rows)
        total = total + cfg.w_scales * terms["scales"]
    terms["total"] = total
    return terms
