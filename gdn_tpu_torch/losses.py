"""Training losses of the two-stage guided depth pipeline (port of
``gdn_tpu/losses.py``): masked L1, the multi-scale gradient L1, SSIM and
the stage-2 latent feature matching, composed by ``total_loss``.

``LossConfig.use_pallas`` picks the route, on any device: set, recon +
the scale-0 gradient + SSIM come from ``kernels/fused_loss.py`` (the
CUDA kernels for CUDA tensors, their plain version for CPU tensors) and
the coarser gradient scales stay here; unset, every term is the plain
PyTorch below.  Maps are (B, H, W) or (B, H, W, 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from gdn_tpu_torch.config import LossConfig
from gdn_tpu_torch.kernels.fused_loss import fused_loss_terms
from gdn_tpu_torch.ops.ssim import ssim


def _squeeze(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.dim() == 4 else x


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of (B, H, W); truncates an odd trailing row/col."""
    b, h, w = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, : h2 * 2, : w2 * 2].reshape(b, h2, 2, w2, 2).mean(dim=(2, 4))


def masked_l1(pred, gt, mask) -> torch.Tensor:
    """Mean |pred - gt| over valid pixels."""
    mask = mask.float()
    diff = torch.abs(pred.float() - gt.float()) * mask
    return diff.sum() / torch.clamp(mask.sum(), min=1.0)


def _grads(x: torch.Tensor):
    """Forward-difference spatial gradients of (B, H, W)."""
    return x[:, :, 1:] - x[:, :, :-1], x[:, 1:, :] - x[:, :-1, :]


def _gradient_scale_losses(pred, gt, mask, num_scales: int,
                           skip_first: bool = False):
    """Per-scale gradient L1 terms (a list of scalars), fine to coarse.
    With ``skip_first`` the scale-0 term (the fused kernel's) is left
    out; the pooling chain is the same either way.  A coarse pixel is
    valid only where all 4 children are (see the JAX package)."""
    terms = []
    for s in range(num_scales):
        if s > 0:
            pred = _avgpool2(pred)
            gt_w = _avgpool2(gt * mask)
            m_w = _avgpool2(mask)
            gt = gt_w / torch.clamp(m_w, min=1e-6)
            mask = (m_w > 0.999).float()
        if s == 0 and skip_first:
            continue
        pdx, pdy = _grads(pred)
        gdx, gdy = _grads(gt)
        mdx = mask[:, :, 1:] * mask[:, :, :-1]
        mdy = mask[:, 1:, :] * mask[:, :-1, :]
        nx = torch.clamp(mdx.sum(), min=1.0)
        ny = torch.clamp(mdy.sum(), min=1.0)
        terms.append((torch.abs(pdx - gdx) * mdx).sum() / nx
                     + (torch.abs(pdy - gdy) * mdy).sum() / ny)
    return terms


def gradient_loss(pred, gt, mask, num_scales: int = 4) -> torch.Tensor:
    """Multi-scale L1 on spatial gradients of pred vs gt."""
    pred = _squeeze(pred).float()
    gt = _squeeze(gt).float()
    mask = _squeeze(mask).float()
    return sum(_gradient_scale_losses(pred, gt, mask, num_scales)) / num_scales


def ssim_loss(pred, gt, max_depth: float, window: int = 11, sigma: float = 1.5,
              precision: str = "highest",
              image_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 - SSIM) / 2 on depth normalized by max_depth; ``image_weights``
    (B,) drops whole images (all-masked ones) from the mean."""
    p = _squeeze(pred).float() / max_depth
    g = _squeeze(gt).float() / max_depth
    s_map = ssim(p, g, max_val=1.0, window=window, sigma=sigma,
                 precision=precision, mean=False)
    if image_weights is None:
        s = s_map.mean()
    else:
        w = image_weights.float()
        s = (s_map.mean(dim=(1, 2)) * w).sum() / torch.clamp(w.sum(), min=1.0)
    return (1.0 - s) / 2.0


def latent_loss(feats_a: Sequence[torch.Tensor],
                feats_b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Guidance feature matching: mean L1 between feature pyramids;
    ``feats_b`` is the (no-grad) target."""
    if len(feats_a) != len(feats_b):
        raise ValueError(
            f"feature pyramids differ in depth: {len(feats_a)} vs {len(feats_b)}")
    total = 0.0
    for a, b in zip(feats_a, feats_b):
        total = total + torch.abs(a.float() - b.float()).mean()
    return total / max(len(feats_a), 1)


def total_loss(
    pred: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor,
    cfg: LossConfig,
    max_depth: float,
    pred_latents: Sequence[torch.Tensor] = (),
    target_latents: Sequence[torch.Tensor] = (),
    scale_preds: Sequence[torch.Tensor] = (),
) -> Dict[str, torch.Tensor]:
    """Composite loss: a dict with 'total' and each term."""
    if scale_preds:
        raise NotImplementedError(
            "multiscale_depth_loss is not ported yet; see ROADMAP.md Queue A "
            "item 4")
    if cfg.use_pallas:
        fused = fused_loss_terms(pred, gt, mask, max_depth, cfg.ssim_window,
                                 cfg.ssim_sigma, precision=cfg.ssim_precision)
        coarse = _gradient_scale_losses(
            _squeeze(pred).float(), _squeeze(gt).float(), _squeeze(mask).float(),
            cfg.grad_scales, skip_first=True)
        terms = {
            "recon": fused["recon"],
            "grad": (fused["grad0"] + sum(coarse)) / cfg.grad_scales,
            "ssim": fused["ssim"],
        }
    else:
        valid = (_squeeze(mask).float().sum(dim=(1, 2)) > 0).float()
        terms = {
            "recon": masked_l1(pred, gt, mask),
            "grad": gradient_loss(pred, gt, mask, cfg.grad_scales),
            "ssim": ssim_loss(pred, gt, max_depth, cfg.ssim_window,
                              cfg.ssim_sigma, precision=cfg.ssim_precision,
                              image_weights=valid),
        }
    total = (cfg.w_recon * terms["recon"] + cfg.w_grad * terms["grad"]
             + cfg.w_ssim * terms["ssim"])
    if pred_latents and target_latents:
        terms["latent"] = latent_loss(pred_latents, target_latents)
        total = total + cfg.w_latent * terms["latent"]
    terms["total"] = total
    return terms
