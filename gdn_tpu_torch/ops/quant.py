"""Int8 post-training quantization of the G-net's inference path (port
of ``gdn_tpu/ops/quant.py``, whose docstring gives the scheme and the
TPU measurements behind it; none of those numbers describe this port).

Scheme, as the JAX package's: symmetric int8, per-output-channel weight
scales computed from the fp32 parameters at every call, static
per-tensor activation scales from a calibration pass, the depth head in
fp32.  Training with ``quant="int8"`` is refused by the train steps
(``train/steps.py``): rounding has a zero gradient.

In the port each quantized conv site (``models/blocks.py``) holds its
activation scale in a non-persistent 0-d buffer ``x_scale``, so its key
is the flax path of the JAX package's ``"quant"`` collection, dotted
(``encoder.down0.ConvBlock_0.x_scale``), and a params-only state_dict
still loads with ``strict=True``.  Scales come in separately, as the JAX
package keeps two collections: ``set_quant_scales``, or
``checkpoint.quant_from_flax`` for the JAX collection.

Numerics, held to the JAX package on the CPU
(``tests/test_torch_quant.py``): XLA compiles the divisions by the
constant 127 as products with its reciprocal, and so does this module
(``INV127``); the activation quotient ``x / s`` is a true division, as
XLA computes it where the scales are arguments of the program
(``make_eval_forward``, ``calibrate_quant``).  Where the JAX package
closes over the scales (its ``BatchedPredictor`` and ``export_model``)
XLA computes ``x * (1 / s)`` instead; the two quotients differ in the
last bit now and then, which moves an int8 value only where the
quotient lies within that bit of a .5 boundary.  The port divides in
every path, its artifacts included (the scales are buffers there).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gdn_tpu_torch.ops.conv import same_pads

INV127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's rewrite of x / 127


def quantize_weight_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW fp kernel -> (int8 kernel, (O,) fp32 scales): symmetric per
    output channel, scale_o = max|W[o]| / 127."""
    w = w.float()
    amax = w.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp(amax, min=1e-12) * INV127
    w8 = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127)
    return w8.to(torch.int8), scale


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp activation -> int8 with a static per-tensor scale."""
    s = torch.clamp(scale.float(), min=1e-12)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def im2col_int8(x8: torch.Tensor, k: int, stride: int, k_pad: int) -> torch.Tensor:
    """NHWC int8 x -> its (B * Ho * Wo, k_pad) patch matrix of XLA's SAME
    k x k convolution at ``stride``: column (ky * k + kx) * C + c, zero
    past k * k * C.  Gathered by k * k shifted slices of the padded int8
    tensor (F.unfold takes no int8 on the card)."""
    b, h, w, c = x8.shape
    (t, bo), (l, r) = same_pads(h, k, stride), same_pads(w, k, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    xp = F.pad(x8, (0, 0, l, r, t, bo))
    cols = [xp[:, ky:ky + (ho - 1) * stride + 1:stride, kx:kx + (wo - 1) * stride + 1:stride]
            for ky in range(k) for kx in range(k)]
    if k_pad > k * k * c:
        cols.append(x8.new_zeros((b, ho, wo, k_pad - k * k * c)))
    return torch.cat(cols, dim=3).reshape(b * ho * wo, k_pad)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def conv2d_s32(x8: torch.Tensor, w8: torch.Tensor, stride: int) -> torch.Tensor:
    """Int8 SAME conv of NHWC int8 x8 with the int8 OIHW kernel w8 ->
    (B, Ho, Wo, Cout) int32 sums: ``torch._int_mm`` of the patch matrix
    and the kernel.  K = k * k * Cin is padded to a multiple of 8 (the
    7x7 stem's 147 to 152) and Cout likewise, and M to more than 16 rows,
    as the card's int8 product asks; the pads are zero and dropped."""
    cout, cin, k = w8.shape[0], w8.shape[1], w8.shape[2]
    kp, np_ = _pad8(k * k * cin), _pad8(cout)
    a = im2col_int8(x8, k, stride, kp)
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    wk = F.pad(w8.permute(0, 2, 3, 1).reshape(cout, k * k * cin),
               (0, kp - k * k * cin, 0, np_ - cout))
    y = torch._int_mm(a, wk.t())[:m, :cout]  # the kernel column-major
    b, h, w = x8.shape[:3]
    return y.reshape(b, -(-h // stride), -(-w // stride), cout)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, stride: int,
                x_scale: torch.Tensor) -> torch.Tensor:
    """Quantized SAME conv of x (B, Cin, H, W), channels_last memory, with
    the fp32 OIHW kernel ``w``: s8 x s8 -> s32 (``conv2d_s32``),
    dequantized to fp32 as ``y * (max(x_scale, 1e-12) * w_scale[o])``.
    Returns (B, Cout, Ho, Wo) fp32, channels_last memory.

    Quantizing commutes with the gather, because SAME's zero padding
    quantizes to 0, so x is quantized first and the int8 tensor is
    gathered (``im2col_int8``).  The JAX package computes this conv in
    XLA, outside any Pallas kernel; here the product is the library's."""
    w8, w_scale = quantize_weight_per_channel(w)
    x8 = quantize_act(x.permute(0, 2, 3, 1), x_scale)  # NHWC view of channels_last
    y = conv2d_s32(x8, w8, stride).float()
    y = y * (torch.clamp(x_scale.float(), min=1e-12) * w_scale)
    return y.permute(0, 3, 1, 2)


def init_act_scale(x: torch.Tensor) -> torch.Tensor:
    """A site's activation scale from the current batch: absmax / 127
    (a calibration pass sets each site's scale to it)."""
    return x.float().abs().amax() * INV127


def quant_sites(net: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """{key of the site's scale (the dotted flax path of the "quant"
    collection): the quantized conv site}, in module order."""
    return {f"{name}.x_scale": m for name, m in net.named_modules()
            if getattr(m, "quantized", False)}


def set_quant_scales(net: torch.nn.Module, scales: Dict[str, Any]) -> None:
    """Copy calibrated scales into ``net``'s sites.  Raises unless the
    keys are exactly the net's sites."""
    sites = quant_sites(net)
    if set(scales) != set(sites):
        raise ValueError(
            f"quant scales do not match the net's int8 sites: missing "
            f"{sorted(set(sites) - set(scales))}, unexpected {sorted(set(scales) - set(sites))}")
    with torch.no_grad():
        for key, m in sites.items():
            m.x_scale.copy_(torch.as_tensor(scales[key], dtype=torch.float32))


def calibrate_quant(net: torch.nn.Module, rgb_batches: Iterable[Any]) -> Dict[str, torch.Tensor]:
    """Calibrate the activation scales of an int8 net (``quant="int8"``).

    Runs ``net`` over representative RGB batches (B, H, W, 3) in [0, 1];
    in each forward every site takes that batch's absmax / 127 as its
    scale and quantizes with it (the JAX package's ``mutable=["quant"]``
    apply), and batches merge by elementwise max.  Leaves the merged
    scales set in ``net`` and returns them as fp32 CPU 0-d tensors."""
    sites = quant_sites(net)
    if not sites:
        cfg = getattr(net, "cfg", None)
        raise ValueError(
            "calibration quantized ZERO conv sites: quant_min_channels"
            f"={getattr(cfg, 'quant_min_channels', '?')} exceeds every conv's input "
            "channel count, so int8 would be a no-op: lower the threshold or drop "
            "--quantize")
    device = next(net.parameters()).device
    merged: Optional[Dict[str, torch.Tensor]] = None
    try:
        for m in sites.values():
            m.calibrating = True
        with torch.no_grad():
            for rgb in rgb_batches:
                net(torch.as_tensor(rgb).to(device))
                got = {k: m.x_scale.detach().float().cpu() for k, m in sites.items()}
                merged = got if merged is None else {
                    k: torch.maximum(merged[k], v) for k, v in got.items()}
    finally:
        for m in sites.values():
            m.calibrating = False
    if merged is None:
        raise ValueError("calibrate_quant needs at least one batch")
    set_quant_scales(net, merged)
    return merged


def synthetic_calibration_batches(cfg, n_batches: int = 8, batch_size: int = 8,
                                  seed: int = 0):
    """Representative RGB batches when no data is at hand: the synthetic
    scene generator at the model's resolution, drawn from a CPU generator
    so that every device calibrates on the same images (CPU tensors).
    Calibrating on real images is better where they exist."""
    from gdn_tpu_torch.data.synthetic import synthetic_batch

    h, w = cfg.model.image_size
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n_batches):
        yield synthetic_batch(gen, batch_size, h, w, cfg.model.max_depth)["rgb"]


def real_calibration_batches(cfg, calib_dir: str, batch_size: int = 8,
                             max_images: int = 64) -> List[torch.Tensor]:
    """RGB batches from a directory of real images (``demo.iter_frames``
    formats), resized to the model's resolution in fp32, at most
    ``max_images`` of them (CPU tensors)."""
    from gdn_tpu_torch.demo import iter_frames
    from gdn_tpu_torch.ops.resize import resize_bilinear

    h, w = cfg.model.image_size
    imgs = [
        resize_bilinear(torch.from_numpy(rgb.astype(np.float32) / 255.0)
                        .permute(2, 0, 1)[None], (h, w))[0].permute(1, 2, 0)
        for _, rgb in itertools.islice(iter_frames(calib_dir), max_images)
    ]
    if not imgs:
        raise ValueError(f"no images found in calibration dir {calib_dir}")
    return [torch.stack(imgs[i:i + batch_size]) for i in range(0, len(imgs), batch_size)]


def train_split_calibration_batches(cfg, n_batches: int = 4) -> List[torch.Tensor]:
    """The first ``n_batches`` train-split batches, wire-decoded and not
    augmented (CPU tensors).  Held-in data: calibrating eval-time int8 on
    the scored images would leak their statistics into the metrics."""
    from gdn_tpu_torch.data.augment import decode_wire_batch
    from gdn_tpu_torch.data.pipeline import host_tensor, make_loader

    def collect(batch_size: int):
        c = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                              batch_size=batch_size))
        loader = make_loader(c, "train", device="cpu")
        depth_scale = float(getattr(loader, "wire_depth_scale", 256.0))
        out = []
        for batch in loader:
            batch = decode_wire_batch({k: host_tensor(v) for k, v in batch.items()},
                                      max_depth=float(cfg.model.max_depth),
                                      depth_scale=depth_scale)
            out.append(batch["rgb"].float())
            if len(out) >= n_batches:
                break
        if not out:
            raise ValueError("train split yielded no batches")
        return out

    try:
        return collect(min(8, cfg.data.batch_size))
    except ValueError:
        # corpora smaller than one batch: the looping loaders refuse, so
        # calibrate image by image
        return collect(1)


def resolve_calibration_batches(cfg, calib_dir: Optional[str] = None,
                                prefer_train_split: bool = False):
    """The calibration source, in order of preference: a directory of
    real images, the train split (with ``prefer_train_split``; keeps eval
    metrics free of leakage), the synthetic scenes.  -> (batches, label)."""
    if calib_dir:
        return real_calibration_batches(cfg, calib_dir), f"dir:{calib_dir}"
    if prefer_train_split and cfg.data.dataset != "synthetic":
        try:
            return train_split_calibration_batches(cfg), "train-split"
        except Exception as e:  # noqa: BLE001 - said aloud, as the JAX package does
            print(f"int8: train-split calibration unavailable ({type(e).__name__}: {e}); "
                  "using synthetic scenes")
    return list(synthetic_calibration_batches(cfg)), "synthetic"


def quantized_model_and_scales(cfg, state_dict: Dict[str, torch.Tensor],
                               calib_batches=None, calib_dir: Optional[str] = None,
                               prefer_train_split: bool = False, device=None):
    """(int8 RtoDNet on ``device`` with ``state_dict`` and its calibrated
    scales, the scales) for the command-line surfaces.  ``cfg.model.quant``
    must be "int8".  Calibration source: ``calib_batches`` > ``calib_dir``
    > the train split (with ``prefer_train_split``) > synthetic scenes."""
    from gdn_tpu_torch.config import resolve_device
    from gdn_tpu_torch.models import RtoDNet

    if cfg.model.quant != "int8":
        raise ValueError(f"quantized_model_and_scales needs model.quant='int8', got "
                         f"{cfg.model.quant!r}")
    device = resolve_device(device)
    if device.type == "cuda":
        from gdn_tpu_torch import kernels

        kernels.load_all()
    net = RtoDNet(cfg.model)
    net.load_state_dict(state_dict, strict=True)
    net = net.to(device).eval()
    if calib_batches is None:
        calib_batches, label = resolve_calibration_batches(
            cfg, calib_dir=calib_dir, prefer_train_split=prefer_train_split)
        print(f"int8: calibrating on {label}")
    return net, calibrate_quant(net, calib_batches)
