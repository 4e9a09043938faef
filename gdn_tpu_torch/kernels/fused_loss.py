"""The fused depth loss: wrappers of the hand-written CUDA kernels, and
their plain PyTorch versions.

Replaces the TPU kernels of ``gdn_tpu/kernels/fused_loss.py``: the
forward ``_call_fwd`` and the backward ``_call_bwd``.  The kernels
(``csrc/fused_loss.cu``, whose header says what bounds them and how
they are built) compute, per image, the 8 partial sums

  [ S|p-g|m, Sm, S|dx p - dx g|m_dx, Sm_dx, S|dy p - dy g|m_dy, Sm_dy,
    S SSIM(p/max, g/max), H*W ]

in one cooperative launch (tiles of ``FWD_TILE`` staged with a halo of
``max(half, 1)``, walked by a resident grid that ``fwd_plan`` sizes; each
tile's sums go to a (B, tiles, 8) scratch, folded per image in tile
order after a grid-wide barrier: deterministic, no atomics), and, for
per-image cotangents (ct_l1, ct_gx, ct_gy, ct_ssim), dL/dpred in closed
form, in one launch that keeps the SSIM adjoint maps in shared memory
(tiles of ``BWD_TILE`` staged with a ``BWD_HALO``-pixel halo).
``fused_loss_terms`` binds the two as one ``torch.autograd.Function``
and normalizes the sums in PyTorch, as the JAX package does outside its
kernel.

A CPU tensor runs the plain version (sums through ``ops/ssim.py``, the
gradient by autograd); a CUDA tensor launches the kernels or raises.
The SSIM blur is fp32 throughout: ``precision`` is checked and ignored
(on the TPU it picks MXU passes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from gdn_tpu_torch.kernels import build
from gdn_tpu_torch.parallel.mesh import global_sum, group_size
from gdn_tpu_torch.ops.ssim import (
    blur, blur_matrices, check_precision, gaussian_kernel_1d,
)

# Output column layout of the forward.
_L1, _NM, _GX, _NGX, _GY, _NGY, _SSIM, _NPIX = range(8)
# SSIM runs on inputs normalized by 1/max_val -> constants at L=1
C1 = 0.01 ** 2
C2 = 0.03 ** 2
FWD_TILE = (32, 64)  # (rows, cols) of one forward tile, as in the CUDA source
BWD_TILE = (32, 64)  # (rows, cols) of one backward block, as in the CUDA source
BWD_HALO = 10  # staged halo of a backward tile: 5 for the moments, 5 for the maps
_MAX_HALF = 5
_MIN_SIDE = 6


class FwdPlan(NamedTuple):
    tiles_y: int  # tile rows of an image
    tiles_x: int  # tile columns of an image
    grid: int  # blocks, all resident at once
    tiles_per_block: int  # the most any block walks


def fwd_plan(b: int, h: int, w: int, resident_blocks: int) -> FwdPlan:
    """Tiles and grid of one forward call on (b, h, w) maps, for a card
    that holds ``resident_blocks`` blocks of the kernel at once: tiles of
    ``FWD_TILE`` (the last row and column of an image ragged), and a grid
    of at most ``resident_blocks`` blocks, block k walking the (image,
    tile) jobs k, k + grid, ... in image-major order."""
    if resident_blocks < 1:
        raise ValueError(f"the card holds {resident_blocks} blocks of the kernel")
    ty, tx = -(-h // FWD_TILE[0]), -(-w // FWD_TILE[1])
    total = b * ty * tx
    grid = min(resident_blocks, total)
    return FwdPlan(ty, tx, grid, -(-total // grid))


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, argtypes set."""
    lib = build.load("fused_loss")
    if lib.fused_loss_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_loss_forward.argtypes = [p] * 6 + [i] * 7 + [f] * 3 + [p]
        lib.fused_loss_backward.argtypes = [p] * 6 + [i] * 4 + [f] * 3 + [p]
        lib.fused_loss_forward_occupancy.argtypes = [i, p]
        for fn in (lib.fused_loss_forward_attrs, lib.fused_loss_backward_attrs):
            fn.argtypes = [p]
        for fn in (lib.fused_loss_forward, lib.fused_loss_backward,
                   lib.fused_loss_forward_occupancy, lib.fused_loss_forward_attrs,
                   lib.fused_loss_backward_attrs):
            fn.restype = ctypes.c_int
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


@functools.lru_cache(maxsize=None)
def _resident(device: int, half: int) -> int:
    """Blocks of the forward kernel for ``half`` that the device holds at
    once (SMs times blocks an SM), queried once; raises where the card
    takes no cooperative launch."""
    sms, per_sm, coop = _attrs("fused_loss_forward_occupancy", 3, half)
    if per_sm < 1:
        raise RuntimeError(f"the forward kernel fits {per_sm} blocks an SM")
    if not coop:
        raise RuntimeError("the card does not take cooperative launches")
    return sms * per_sm


def plan_for(pred: torch.Tensor, window: int = 11) -> FwdPlan:
    """The plan the forward kernel takes for CUDA maps (B, H, W)."""
    b, h, w = pred.shape
    with torch.cuda.device(pred.device):  # the query reads the current device
        return fwd_plan(b, h, w, _resident(pred.device.index, window // 2))


def fused_loss_fwd(pred, gt, mask, max_val: float, window: int = 11,
                   sigma: float = 1.5) -> torch.Tensor:
    """(B, 8) fp32 partial sums of fp32 contiguous (B, H, W) CUDA maps."""
    _check_kernel_args(pred, gt, mask, window)
    b, h, w = pred.shape
    plan = plan_for(pred, window)
    partials = torch.empty((b, plan.tiles_y * plan.tiles_x, 8), dtype=torch.float32,
                           device=pred.device)
    out = torch.empty((b, 8), dtype=torch.float32, device=pred.device)
    wt = _weights(window, sigma, pred.device)
    with torch.cuda.device(pred.device):  # the launch goes to the current device
        err = load().fused_loss_forward(
            pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), wt.data_ptr(),
            partials.data_ptr(), out.data_ptr(), b, h, w, window // 2, plan.tiles_y,
            plan.tiles_x, plan.grid, 1.0 / max_val, C1, C2,
            torch.cuda.current_stream(pred.device).cuda_stream,
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
    dpred = torch.empty_like(pred)
    wt = _weights(window, sigma, pred.device)
    with torch.cuda.device(pred.device):
        err = load().fused_loss_backward(
            pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), wt.data_ptr(),
            cts.data_ptr(), dpred.data_ptr(), b, h, w,
            window // 2, 1.0 / max_val, C1, C2,
            torch.cuda.current_stream(pred.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_loss_backward failed: cudaError {err}")
    fused_loss_bwd.launches += 1
    return dpred


fused_loss_fwd.launches = 0
fused_loss_bwd.launches = 0


_RESOURCE_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem", "threads")


def _attrs(name: str, n: int, *args):
    """The n ints the library's function ``name`` writes after ``args``."""
    attrs = (ctypes.c_int * n)()
    err = getattr(load(), name)(*args, attrs)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return list(attrs)


def forward_resources() -> Dict[str, int]:
    """The forward kernel's resources as built for the current device (the
    11-tap instantiation): registers and local (spill) bytes a thread,
    static and dynamic shared bytes, threads a block, and the blocks of it
    that an SM holds."""
    res = dict(zip(_RESOURCE_KEYS, _attrs("fused_loss_forward_attrs", 5)))
    res["blocks_per_sm"] = _attrs("fused_loss_forward_occupancy", 3, _MAX_HALF)[1]
    return res


def backward_resources() -> Dict[str, int]:
    """The backward kernel's resources as built for the current device:
    registers and local (spill) bytes a thread, static and dynamic shared
    bytes and threads a block."""
    return dict(zip(_RESOURCE_KEYS, _attrs("fused_loss_backward_attrs", 5)))


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

def _counts(raw: torch.Tensor, group=None) -> torch.Tensor:
    """The four denominators of the (B, 8) sums: valid pixels, valid x
    and y pairs, and the pixels of the images with a valid pixel; with a
    data-parallel ``group``, summed over its ranks (detached)."""
    tot = raw.sum(0)
    valid = (raw[:, _NM] > 0).float()
    return global_sum(torch.stack([tot[_NM], tot[_NGX], tot[_NGY],
                                   (raw[:, _NPIX] * valid).sum()]), group)


def _normalize(raw: torch.Tensor, counts=None) -> torch.Tensor:
    """(B, 8) sums -> (recon, grad0, ssim_mean) over ``counts``
    (``_counts``; the batch's own by default).  Images with no valid
    pixel are left out of the SSIM mean."""
    c = torch.clamp(_counts(raw) if counts is None else counts, min=1.0)
    tot = raw.sum(0)
    recon = tot[_L1] / c[0]
    grad = tot[_GX] / c[1] + tot[_GY] / c[2]
    valid = (raw[:, _NM] > 0).float()
    ssim_mean = (raw[:, _SSIM] * valid).sum() / c[3]
    return torch.stack([recon, grad, ssim_mean])


def _cotangents(raw: torch.Tensor, ct: torch.Tensor, counts=None) -> torch.Tensor:
    """Upstream ct (3,) of (recon, grad0, ssim_mean) -> per-image (B, 4)
    cotangents of the L1, GX, GY and SSIM sums over ``counts`` (the
    counts are not differentiable; all-masked images get no SSIM
    cotangent)."""
    c = torch.clamp(_counts(raw) if counts is None else counts, min=1.0)
    b = raw.shape[0]
    valid = (raw[:, _NM] > 0).float()
    ct_ssim = ct[2] * valid / c[3]
    shared = torch.stack([ct[0] / c[0], ct[1] / c[1], ct[1] / c[2]]).expand(b, 3)
    return torch.cat([shared, ct_ssim[:, None]], dim=1).float().contiguous()


class _FusedTerms(torch.autograd.Function):
    """(recon, grad0, ssim_mean) of CUDA maps: forward kernel, then the
    backward kernel for dL/dpred."""

    @staticmethod
    def forward(ctx, pred, gt, mask, max_val, window, sigma, group):
        raw = fused_loss_fwd(pred, gt, mask, max_val, window, sigma)
        counts = _counts(raw, group)
        ctx.save_for_backward(pred, gt, mask, raw, counts)
        ctx.args = (max_val, window, sigma)
        return _normalize(raw, counts)

    @staticmethod
    def backward(ctx, ct):
        pred, gt, mask, raw, counts = ctx.saved_tensors
        cts = _cotangents(raw, ct, counts)
        dpred = fused_loss_bwd(pred, gt, mask, cts, *ctx.args)
        return dpred, None, None, None, None, None, None


def fused_loss_terms_plain(pred, gt, mask, max_val: float, window: int = 11,
                           sigma: float = 1.5, group=None) -> torch.Tensor:
    """Plain version of ``_FusedTerms``: (recon, grad0, ssim_mean)."""
    raw = loss_sums_plain(pred, gt, mask, max_val, window, sigma)
    return _normalize(raw, _counts(raw, group))


def fused_loss_terms(pred, gt, mask, max_val: float, window: int = 11,
                     sigma: float = 1.5,
                     precision: str = "highest", group=None) -> Dict[str, torch.Tensor]:
    """Fused (recon, grad-scale-0, ssim) losses of (B, H, W[, 1]) maps.

    Returns {'recon', 'grad0', 'ssim'} with ssim = (1 - mean SSIM) / 2;
    differentiable with respect to pred.  CPU tensors run the plain
    version; CUDA tensors the kernels.  With a data-parallel ``group``
    the terms are this rank's shares (``losses``): the counts are summed
    over the ranks in ``_counts``, around the kernels, which see only
    the rank's rows."""
    check_precision(precision)
    pred, gt, mask = _prep(pred, gt, mask)
    args = (float(max_val), int(window), float(sigma))
    if pred.device.type == "cpu":
        out = fused_loss_terms_plain(pred, gt, mask, *args, group=group)
    else:
        out = _FusedTerms.apply(pred, gt, mask, *args, group)
    return {"recon": out[0], "grad0": out[1],
            "ssim": (1.0 / group_size(group) - out[2]) / 2.0}

