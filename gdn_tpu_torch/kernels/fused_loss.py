"""The fused depth loss: wrappers of the hand-written CUDA kernels, and
their plain PyTorch versions.

Replaces the TPU kernels of ``gdn_tpu/kernels/fused_loss.py``: the
forward ``_call_fwd`` and the backward ``_call_bwd``.  The kernels
(``csrc/fused_loss.cu``, whose header says what bounds them and how
they are built) compute, per image, the 8 partial sums

  [ S|p-g|m, Sm, S|dx p - dx g|m_dx, Sm_dx, S|dy p - dy g|m_dy, Sm_dy,
    S SSIM(p/max, g/max), H*W ]

and, for per-image cotangents (ct_l1, ct_gx, ct_gy, ct_ssim), dL/dpred
in closed form.  ``fused_loss_terms`` binds the two as one
``torch.autograd.Function`` and normalizes the sums in PyTorch, as the
JAX package does outside its kernel.

A CPU tensor runs the plain version (sums through ``ops/ssim.py``, the
gradient by autograd); a CUDA tensor launches the kernels or raises.
The SSIM blur is fp32 throughout: ``precision`` is checked and ignored
(on the TPU it picks MXU passes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from gdn_tpu_torch.kernels import build
from gdn_tpu_torch.ops.ssim import (
    blur, blur_matrices, check_precision, gaussian_kernel_1d,
)

# Output column layout of the forward.
_L1, _NM, _GX, _NGX, _GY, _NGY, _SSIM, _NPIX = range(8)
# SSIM runs on inputs normalized by 1/max_val -> constants at L=1
C1 = 0.01 ** 2
C2 = 0.03 ** 2
_TILE = (16, 32)  # (rows, cols) of one block, as in the CUDA source
_MAX_HALF = 5
_MIN_SIDE = 6


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, argtypes set."""
    lib = build.load("fused_loss")
    if lib.fused_loss_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_loss_forward.argtypes = [p] * 6 + [i] * 4 + [f] * 3 + [p]
        lib.fused_loss_backward.argtypes = [p] * 7 + [i] * 4 + [f] * 3 + [p]
        lib.fused_loss_forward.restype = ctypes.c_int
        lib.fused_loss_backward.restype = ctypes.c_int
    return lib


def _prep(pred, gt, mask):
    """(B, H, W[, 1]) maps -> fp32 contiguous (B, H, W), checked."""
    if pred.dim() == 4:
        pred, gt, mask = pred[..., 0], gt[..., 0], mask[..., 0]
    if pred.dim() != 3 or gt.shape != pred.shape or mask.shape != pred.shape:
        raise ValueError(
            f"pred, gt, mask must be (B, H, W[, 1]) of one shape, got "
            f"{tuple(pred.shape)}, {tuple(gt.shape)}, {tuple(mask.shape)}")
    for name, t in (("pred", pred), ("gt", gt)):
        if not t.is_floating_point():
            raise TypeError(f"{name} dtype {t.dtype} not supported (float)")
    if mask.is_complex():
        raise TypeError(f"mask dtype {mask.dtype} not supported")
    if gt.device != pred.device or mask.device != pred.device:
        raise ValueError("pred, gt and mask must lie on one device")
    return pred.float().contiguous(), gt.float().contiguous(), mask.float().contiguous()


def _check_kernel_args(pred, gt, mask, window):
    """The kernels read three fp32 (B, H, W) maps, dense, on one card."""
    maps = (("pred", pred), ("gt", gt), ("mask", mask))
    if pred.dim() != 3 or gt.shape != pred.shape or mask.shape != pred.shape:
        raise ValueError(
            f"pred, gt, mask must be (B, H, W) of one shape, got "
            f"{tuple(pred.shape)}, {tuple(gt.shape)}, {tuple(mask.shape)}")
    for name, t in maps:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gt.device != pred.device or mask.device != pred.device:
        raise ValueError("pred, gt and mask must lie on one device")
    if pred.device.type != "cuda":
        raise ValueError(f"unsupported device {pred.device}")
    if window % 2 == 0 or window // 2 > _MAX_HALF:
        raise ValueError(f"window {window}: the kernel takes odd windows <= 11")
    if min(pred.shape[1], pred.shape[2]) < _MIN_SIDE:
        raise ValueError(f"H and W must be >= {_MIN_SIDE}, got {tuple(pred.shape)}")


@functools.lru_cache(maxsize=8)
def _weights(window, sigma, device):
    """The window's taps on the device, copied once: a copy from pageable
    memory per call would wait for the stream."""
    return torch.from_numpy(gaussian_kernel_1d(window, sigma)).to(device)


def fused_loss_fwd(pred, gt, mask, max_val: float, window: int = 11,
                   sigma: float = 1.5) -> torch.Tensor:
    """(B, 8) fp32 partial sums of fp32 contiguous (B, H, W) CUDA maps."""
    _check_kernel_args(pred, gt, mask, window)
    b, h, w = pred.shape
    tiles = -(-h // _TILE[0]) * -(-w // _TILE[1])
    partials = torch.empty((b, tiles, 8), dtype=torch.float32, device=pred.device)
    out = torch.empty((b, 8), dtype=torch.float32, device=pred.device)
    wt = _weights(window, sigma, pred.device)
    err = load().fused_loss_forward(
        pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        partials.data_ptr(), out.data_ptr(), b, h, w, window // 2,
        1.0 / max_val, C1, C2, torch.cuda.current_stream(pred.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_loss_forward failed: cudaError {err}")
    fused_loss_fwd.launches += 1
    return out


def fused_loss_bwd(pred, gt, mask, cts, max_val: float, window: int = 11,
                   sigma: float = 1.5) -> torch.Tensor:
    """dL/dpred (B, H, W) fp32 for per-image cotangents cts (B, 4) =
    (ct_l1, ct_gx, ct_gy, ct_ssim) of the sums L1, GX, GY, SSIM."""
    _check_kernel_args(pred, gt, mask, window)
    b, h, w = pred.shape
    if tuple(cts.shape) != (b, 4):
        raise ValueError(f"cts must be ({b}, 4), got {tuple(cts.shape)}")
    if cts.device != pred.device:
        raise ValueError("cts must lie on pred's device")
    cts = cts.float().contiguous()
    amaps = torch.empty((b, 3, h, w), dtype=torch.float32, device=pred.device)
    dpred = torch.empty_like(pred)
    wt = _weights(window, sigma, pred.device)
    err = load().fused_loss_backward(
        pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        cts.data_ptr(), amaps.data_ptr(), dpred.data_ptr(), b, h, w,
        window // 2, 1.0 / max_val, C1, C2,
        torch.cuda.current_stream(pred.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_loss_backward failed: cudaError {err}")
    fused_loss_bwd.launches += 1
    return dpred


fused_loss_fwd.launches = 0
fused_loss_bwd.launches = 0


# ------------------------------------------------------------ plain version

def loss_sums_plain(pred, gt, mask, max_val: float, window: int = 11,
                    sigma: float = 1.5) -> torch.Tensor:
    """Plain version of the forward: the (B, 8) sums, differentiable."""
    b, h, w = pred.shape
    p = pred.float()
    g = gt.float()
    m = mask.float()
    dxp, dxg = p[:, :, 1:] - p[:, :, :-1], g[:, :, 1:] - g[:, :, :-1]
    mdx = m[:, :, 1:] * m[:, :, :-1]
    dyp, dyg = p[:, 1:, :] - p[:, :-1, :], g[:, 1:, :] - g[:, :-1, :]
    mdy = m[:, 1:, :] * m[:, :-1, :]
    inv = 1.0 / max_val
    pn, gn = p * inv, g * inv
    my, mx = blur_matrices(h, w, window, sigma, p.device)
    mu_x, mu_y = blur(pn, my, mx), blur(gn, my, mx)
    sxx = torch.clamp(blur(pn * pn, my, mx) - mu_x * mu_x, min=0.0)
    syy = torch.clamp(blur(gn * gn, my, mx) - mu_y * mu_y, min=0.0)
    sxy = blur(pn * gn, my, mx) - mu_x * mu_y
    s = ((2.0 * mu_x * mu_y + C1) * (2.0 * sxy + C2)) / (
        (mu_x * mu_x + mu_y * mu_y + C1) * (sxx + syy + C2))
    cols = [
        (torch.abs(p - g) * m).sum((1, 2)), m.sum((1, 2)),
        (torch.abs(dxp - dxg) * mdx).sum((1, 2)), mdx.sum((1, 2)),
        (torch.abs(dyp - dyg) * mdy).sum((1, 2)), mdy.sum((1, 2)),
        s.sum((1, 2)), torch.full((b,), float(h * w), device=p.device),
    ]
    return torch.stack(cols, dim=1)


def fused_loss_bwd_plain(pred, gt, mask, cts, max_val: float,
                         window: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Plain version of the backward: autograd of sum(cts * sums)."""
    with torch.enable_grad():
        p = pred.detach().float().requires_grad_(True)
        raw = loss_sums_plain(p, gt, mask, max_val, window, sigma)
        picked = raw[:, [_L1, _GX, _GY, _SSIM]]
        (dpred,) = torch.autograd.grad((picked * cts.float()).sum(), p)
    return dpred


# ------------------------------------------------- normalization, autograd

def _normalize(raw: torch.Tensor) -> torch.Tensor:
    """(B, 8) sums -> (recon, grad0, ssim_mean).  Images with no valid
    pixel are left out of the SSIM mean."""
    tot = raw.sum(0)
    recon = tot[_L1] / torch.clamp(tot[_NM], min=1.0)
    grad = tot[_GX] / torch.clamp(tot[_NGX], min=1.0) + tot[_GY] / torch.clamp(
        tot[_NGY], min=1.0)
    valid = (raw[:, _NM] > 0).float()
    ssim_mean = (raw[:, _SSIM] * valid).sum() / torch.clamp(
        (raw[:, _NPIX] * valid).sum(), min=1.0)
    return torch.stack([recon, grad, ssim_mean])


def _cotangents(raw: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Upstream ct (3,) of (recon, grad0, ssim_mean) -> per-image (B, 4)
    cotangents of the L1, GX, GY and SSIM sums (the counts are not
    differentiable; all-masked images get no SSIM cotangent)."""
    tot = raw.sum(0)
    b = raw.shape[0]
    ct_l1 = ct[0] / torch.clamp(tot[_NM], min=1.0)
    ct_gx = ct[1] / torch.clamp(tot[_NGX], min=1.0)
    ct_gy = ct[1] / torch.clamp(tot[_NGY], min=1.0)
    valid = (raw[:, _NM] > 0).float()
    denom = torch.clamp((raw[:, _NPIX] * valid).sum(), min=1.0)
    ct_ssim = ct[2] * valid / denom
    shared = torch.stack([ct_l1, ct_gx, ct_gy]).expand(b, 3)
    return torch.cat([shared, ct_ssim[:, None]], dim=1).float().contiguous()


class _FusedTerms(torch.autograd.Function):
    """(recon, grad0, ssim_mean) of CUDA maps: forward kernel, then the
    backward kernel for dL/dpred."""

    @staticmethod
    def forward(ctx, pred, gt, mask, max_val, window, sigma):
        raw = fused_loss_fwd(pred, gt, mask, max_val, window, sigma)
        ctx.save_for_backward(pred, gt, mask, raw)
        ctx.args = (max_val, window, sigma)
        return _normalize(raw)

    @staticmethod
    def backward(ctx, ct):
        pred, gt, mask, raw = ctx.saved_tensors
        cts = _cotangents(raw, ct)
        dpred = fused_loss_bwd(pred, gt, mask, cts, *ctx.args)
        return dpred, None, None, None, None, None


def fused_loss_terms_plain(pred, gt, mask, max_val: float, window: int = 11,
                           sigma: float = 1.5) -> torch.Tensor:
    """Plain version of ``_FusedTerms``: (recon, grad0, ssim_mean)."""
    return _normalize(loss_sums_plain(pred, gt, mask, max_val, window, sigma))


def fused_loss_terms(pred, gt, mask, max_val: float, window: int = 11,
                     sigma: float = 1.5,
                     precision: str = "highest") -> Dict[str, torch.Tensor]:
    """Fused (recon, grad-scale-0, ssim) losses of (B, H, W[, 1]) maps.

    Returns {'recon', 'grad0', 'ssim'} with ssim = (1 - mean SSIM) / 2;
    differentiable with respect to pred.  CPU tensors run the plain
    version; CUDA tensors the kernels."""
    check_precision(precision)
    pred, gt, mask = _prep(pred, gt, mask)
    args = (float(max_val), int(window), float(sigma))
    if pred.device.type == "cpu":
        out = fused_loss_terms_plain(pred, gt, mask, *args)
    else:
        out = _FusedTerms.apply(pred, gt, mask, *args)
    return {"recon": out[0], "grad0": out[1], "ssim": (1.0 - out[2]) / 2.0}

