"""The kernels' inference forwards as registered ``torch.library`` ops.

``torch.export`` cannot trace the kernels' ctypes launches: a fake
tensor has no data pointer, and a foreign call is opaque to the tracer.
So the no-grad branch of every wrapper calls one of two ops of the
``gdn_tpu_torch`` namespace, and an exported graph
(``serving.export_model``) holds the op, not the plain version:

- ``gdn_tpu_torch::group_norm_elu(x, scale, bias, groups, eps)``: the
  GroupNorm+ELU kernel (``kernels/groupnorm.py``);
- ``gdn_tpu_torch::conv_gn_elu(entry, x, lat, w, wl, scale, bias,
  groups, eps, stride, upsample, tap_dtype, out_dtype)``: the fused
  conv3x3+GroupNorm+ELU family (``kernels/conv_gn_elu.py``).  ``entry``
  names the entry point whose ``launches`` the call counts (a key of
  ``ENTRIES``); ``lat``/``wl`` are the lateral and its half of the
  weights of the two-input entry points, ``upsample`` the bilinear 2x
  in front of the upsample entry point.

Each op has a CPU implementation, the kernel's plain version; a CUDA
implementation, the launch (which adds one to the entry point's
``launches``, and raises where it fails: nothing falls back); and a fake
one, which returns the kernel's exact shape, dtype and channels_last
strides, so that views traced after the op hold at run time.  Importing
``gdn_tpu_torch.kernels`` registers both, which is all a process that
loads an exported artifact needs of the port.  The autograd Functions
of the training path do not go through the ops.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch

CL = torch.channels_last

# entry point -> its module under gdn_tpu_torch.kernels (the wrapper
# carries the launch count)
ENTRIES = {
    "fused_conv_gn_elu": "conv_gn_elu",
    "fused_conv_gn_elu_bt": "conv_gn_elu",
    "fused_conv_gn_elu_s2": "conv_gn_elu",
    "fused_fusion_bt": "fusion_bt",
    "fused_fusion_block": "fusion_block",
    "fused_upsample_conv": "upsample",
}


def _module(name: str):
    # imported at call time: those modules import this one
    return importlib.import_module(f"gdn_tpu_torch.kernels.{name}")


@torch.library.custom_op("gdn_tpu_torch::group_norm_elu", mutates_args=(),
                         device_types="cpu")
def group_norm_elu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    from gdn_tpu_torch.ops.groupnorm import group_norm_elu_analytic

    return group_norm_elu_analytic(x, scale, bias, groups, eps).contiguous(
        memory_format=CL)


@group_norm_elu.register_kernel("cuda")
def _group_norm_elu_cuda(x, scale, bias, groups, eps):
    return _module("groupnorm")._launch(x, scale, bias, groups, eps)[0]


@group_norm_elu.register_fake
def _group_norm_elu_fake(x, scale, bias, groups, eps):
    return torch.empty_like(x, memory_format=CL)


@torch.library.custom_op("gdn_tpu_torch::conv_gn_elu", mutates_args=(),
                         device_types="cpu")
def conv_gn_elu(entry: str, x: torch.Tensor, lat: Optional[torch.Tensor],
                w: torch.Tensor, wl: Optional[torch.Tensor], scale: torch.Tensor,
                bias: torch.Tensor, groups: int, eps: float, stride: int,
                upsample: bool, tap_dtype: str, out_dtype: torch.dtype) -> torch.Tensor:
    if upsample:
        a = _module("upsample").upsample_conv_plain(x, w, scale, bias, groups, eps,
                                                    tap_dtype)
        return a.to(out_dtype).contiguous(memory_format=CL)
    return _module("conv_gn_elu").conv_gn_elu_plain(
        x, w, scale, bias, groups, eps, stride, tap_dtype, out_dtype, lat, wl)[0]


@conv_gn_elu.register_kernel("cuda")
def _conv_gn_elu_cuda(entry, x, lat, w, wl, scale, bias, groups, eps, stride, upsample,
                      tap_dtype, out_dtype):
    counter = getattr(_module(ENTRIES[entry]), entry)
    return _module("conv_gn_elu")._launch(
        counter, x, lat, w, wl, scale, bias, groups, eps, stride, tap_dtype, out_dtype,
        False, upsample=upsample)[0]


@conv_gn_elu.register_fake
def _conv_gn_elu_fake(entry, x, lat, w, wl, scale, bias, groups, eps, stride, upsample,
                      tap_dtype, out_dtype):
    b, _, h, wd = x.shape
    if upsample:
        ho, wo = 2 * h, 2 * wd
    else:
        ho, wo = (h + stride - 1) // stride, (wd + stride - 1) // stride
    return torch.empty((b, w.shape[0], ho, wo), dtype=out_dtype, device=x.device,
                       memory_format=CL)
