"""GroupNorm+ELU: wrapper of the hand-written CUDA kernel.

Replaces the TPU kernel ``gdn_tpu/kernels/groupnorm.py::
fused_group_norm_elu``.  The kernel (``csrc/group_norm_elu.cu``) is
memory-bound; its header says how its two launches deal with that.
Unlike the TPU kernel it needs no lane packing and no VMEM gate, so it
covers every GN site of the net (C = 16 ... 512).

Numerics: statistics in fp32 (single-pass, clamped at 0), then fp32
math until the one store in the input dtype, like the TPU kernel.  The
plain version (``ops/groupnorm.py::group_norm_elu_plain``) rounds the
mean and inverse to the compute dtype first, like the JAX package's
analytic form; in bf16 the two differ by a few bf16 ulps of the output
(held to atol 0.05, the JAX suite's bound for the same pair).

Gradient: where the input or the affine parameters require grad, the
kernel runs inside ``_GroupNormELUKernel``, an autograd Function that
keeps x and the fp32 per-(B, C) mean and inverse std folded from the
kernel's partials, and whose backward is the JAX package's analytic
two-reduce backward in plain PyTorch (``ops.groupnorm.gn_elu_backward``;
on the TPU that backward is XLA, not a Pallas kernel).  Without grad
(serving, the frozen D-net) the kernel is called directly and nothing
is kept.  On the CPU every site runs ``group_norm_elu_analytic``.
"""

from __future__ import annotations

import ctypes

import torch

from gdn_tpu_torch.kernels import build
from gdn_tpu_torch.ops.groupnorm import gn_elu_backward, group_norm_elu_analytic

# Elements one block of each launch covers; sets the chunk count.
_BLOCK_ELEMS = 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 1024


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library, with argtypes set.
    Call before a worker thread first launches the kernel."""
    lib = build.load("group_norm_elu")
    fn = lib.gn_elu_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, scale, bias, groups):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got shape {tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"C={c} is not divisible by groups={groups}")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(
            f"scale/bias must be ({c},), got {tuple(scale.shape)}, "
            f"{tuple(bias.shape)}"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32|bfloat16)")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must lie on one device")


def _launch(x, scale, bias, groups, eps):
    """Run the kernel on channels_last CUDA x -> (out, partials)."""
    b, c, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous (NHWC memory)")
    if c > _MAX_C:
        raise ValueError(f"C={c} exceeds the kernel's limit of {_MAX_C}")
    scale = scale.detach().float().contiguous()
    bias = bias.detach().float().contiguous()
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        vec = 1
    hw = h * w
    rows = max(1, _BLOCK_ELEMS // c)
    chunks = -(-hw // rows)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    partials = torch.empty((b, groups, chunks, 2), dtype=torch.float32,
                           device=x.device)
    err = load().gn_elu_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        partials.data_ptr(), b, hw, c, groups, rows, chunks, float(eps),
        _DTYPES[x.dtype], vec, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gn_elu_forward failed: cudaError {err}")
    group_norm_elu.launches += 1
    return out, partials


def _stats_from_partials(partials, c, hw, eps):
    """The kernel's (B, G, chunks, 2) partial sums -> fp32 (B, C) mean
    and inverse std, folded as the kernel folds them (clamped var)."""
    b, groups = partials.shape[:2]
    cg = c // groups
    s = partials.sum(2)  # (B, G, 2)
    n = float(hw * cg)
    mean = s[..., 0] / n
    inv = torch.rsqrt(torch.clamp(s[..., 1] / n - mean * mean, min=0.0) + eps)
    return mean.repeat_interleave(cg, 1), inv.repeat_interleave(cg, 1)


class _GroupNormELUKernel(torch.autograd.Function):
    """Kernel forward, analytic plain-PyTorch backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        out, partials = _launch(x, scale, bias, groups, eps)
        mean_c, inv_c = _stats_from_partials(partials, x.shape[1],
                                             x.shape[2] * x.shape[3], eps)
        ctx.save_for_backward(x, mean_c, inv_c, scale, bias)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, da):
        x, mean_c, inv_c, scale, bias = ctx.saved_tensors
        dt = x.dtype
        yn = (x - mean_c.to(dt)[:, :, None, None]) * inv_c.to(dt)[:, :, None, None]
        dy, dscale, dbias = gn_elu_backward(da, yn, inv_c, scale, bias, ctx.groups)
        return dy, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def group_norm_elu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm + ELU of x (B, C, H, W), channels_last memory.

    scale, bias: (C,).  Returns x's shape, dtype and memory format,
    differentiable in x, scale and bias.  A CPU tensor runs the plain
    analytic form; a CUDA tensor launches the kernel or raises."""
    _check(x, scale, bias, groups)
    if x.device.type == "cpu":
        return group_norm_elu_analytic(x, scale, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _GroupNormELUKernel.apply(x, scale, bias, groups, eps)
    return _launch(x, scale, bias, groups, eps)[0]


group_norm_elu.launches = 0
