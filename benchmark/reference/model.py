"""The plain reference of the guided depth net: both nets' forward, the
stage-2 loss, its gradients by autograd and optax's Adam, written from
the published architecture in plain PyTorch.

It imports nothing of the program and takes none of its tensors: the
parameters are a dict keyed by the flax paths (``param_shapes`` lists
them), made by ``benchmark/harness/inputs.py`` from the seed; inputs
come from ``benchmark/harness/inputs.py``.  Tensors are NCHW float32.

``precision`` says what the tensors a bfloat16 program holds in its
compute type are held in: "fp32" (the reference; ``reference_mode``
turns TF32 off) or "fp8" (the control: the net's input, each conv's
input, weight and output, each resize's and each GroupNorm+ELU's output
rounded to float8 e4m3 under a per-tensor scale, and the gradient
reaching each of them to e5m2, as float8 training does; the arithmetic
in float32).  The head and the loss are float32 in both, as in the
program.

What the net is (Song & Kim, IEEE Access 7:142595, as the port's
``config.py`` presets it): a 7x7 stem and five stride-2 levels, each a
stride-2 3x3 conv and a 3x3 refine, every conv followed by GroupNorm
(8 groups, eps 1e-6) and ELU; a decoder of five levels, each a bilinear
resize to the skip's size (half-pixel centers, no antialias: it only
grows), a 3x3 conv with GroupNorm+ELU, then a 3x3 conv over the
concatenation of that and the skip with GroupNorm+ELU; a 3x3 head with
bias, sigmoid, times max depth.  Convolutions pad as XLA's "SAME" does
(the extra row and column at the bottom and right).
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

GN_EPS = 1e-6
GROUPS = 8

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: Dict, in_channels: int) -> "OrderedDict[str, Tuple[int, ...]]":
    """The parameters of a D-net (``in_channels`` 1) or G-net (3), keyed by
    their flax paths, convolution kernels OIHW."""
    enc, dec = cfg["enc_channels"], cfg["dec_channels"]
    out: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()

    def block(prefix, cin, cout, k):
        out[f"{prefix}.Conv_0.kernel"] = (cout, cin, k, k)
        out[f"{prefix}.gn_scale"] = (cout,)
        out[f"{prefix}.gn_bias"] = (cout,)

    block("encoder.stem", in_channels, enc[0], 7)
    cin = enc[0]
    for i, ch in enumerate(enc):
        block(f"encoder.down{i}.ConvBlock_0", cin, ch, 3)
        block(f"encoder.down{i}.ConvBlock_1", ch, ch, 3)
        cin = ch
    skips = [enc[0], *enc[:-1]]
    for i, ch in enumerate(dec):
        lat = skips[len(skips) - 1 - i]
        p = f"decoder.up{i}"
        out[f"{p}.up_kernel"] = (ch, cin, 3, 3)
        out[f"{p}.up_scale"] = (ch,)
        out[f"{p}.up_bias"] = (ch,)
        out[f"{p}.fuse.kernel"] = (ch, ch + lat, 3, 3)
        out[f"{p}.fuse.scale"] = (ch,)
        out[f"{p}.fuse.bias"] = (ch,)
        cin = ch
    out["decoder.head.Conv_0.kernel"] = (1, cin, 3, 3)
    out["decoder.head.Conv_0.bias"] = (1,)
    return out


@contextlib.contextmanager
def reference_mode():
    """Full float32 products: TF32 off for matmuls and cuDNN convs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` under a per-tensor scale (its
    absmax to the type's largest), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


class _FP8(torch.autograd.Function):
    """float8 training's rounding: the value to e4m3, its gradient to
    e5m2, each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(t)


def quantizer(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision == "fp32":
        return lambda t: t
    if precision == "fp8":
        return _fp8
    raise ValueError(f"unknown precision {precision!r} (fp32|fp8)")


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1, bias=None, q=quantizer("fp32")):
    """XLA "SAME" convolution of NCHW x with an OIHW kernel."""
    (t, b), (l, r) = _same_pads(x.shape[2], w.shape[2], stride), _same_pads(
        x.shape[3], w.shape[3], stride)
    return q(F.conv2d(F.pad(q(x), (l, r, t, b)), q(w), bias, stride))


def gn_elu(y, scale, bias, groups=GROUPS, eps=GN_EPS):
    """GroupNorm (two-pass variance, float32) then ELU."""
    b, c, h, w = y.shape
    g = y.reshape(b, groups, c // groups * h * w)
    mean = g.mean(dim=2, keepdim=True)
    var = (g - mean).square().mean(dim=2, keepdim=True)
    n = ((g - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return F.elu(n * scale[None, :, None, None] + bias[None, :, None, None])


def encoder(p: Params, x, q):
    """(latent, skips fine -> coarse)."""
    n = sum(1 for k in p if k.startswith("encoder.down") and k.endswith("ConvBlock_0.gn_scale"))

    def block(prefix, x, stride):
        return q(gn_elu(conv(x, p[f"{prefix}.Conv_0.kernel"], stride, q=q),
                        p[f"{prefix}.gn_scale"], p[f"{prefix}.gn_bias"]))

    x = block("encoder.stem", q(x), 1)
    skips = []
    for i in range(n):
        skips.append(x)
        x = block(f"encoder.down{i}.ConvBlock_0", x, 2)
        x = block(f"encoder.down{i}.ConvBlock_1", x, 1)
    return x, skips


def decoder(p: Params, latent, skips: Sequence[torch.Tensor], max_depth: float, q):
    """(depth (B, 1, H, W), decoder features coarse -> fine)."""
    n = sum(1 for k in p if k.startswith("decoder.up") and k.endswith(".up_kernel"))
    x, feats, m = latent, [], len(skips)
    for i in range(n):
        skip = skips[m - 1 - i]
        u = q(F.interpolate(x, size=tuple(skip.shape[2:]), mode="bilinear",
                            align_corners=False))
        pre = f"decoder.up{i}"
        x = q(gn_elu(conv(u, p[f"{pre}.up_kernel"], q=q), p[f"{pre}.up_scale"],
                     p[f"{pre}.up_bias"]))
        x = q(gn_elu(conv(torch.cat([x, skip], dim=1), p[f"{pre}.fuse.kernel"], q=q),
                     p[f"{pre}.fuse.scale"], p[f"{pre}.fuse.bias"]))
        feats.append(x)
    y = conv(x, p["decoder.head.Conv_0.kernel"], bias=p["decoder.head.Conv_0.bias"])
    return torch.sigmoid(y) * max_depth, feats


def g_forward(p: Params, rgb_nhwc, max_depth: float, q=quantizer("fp32")):
    """The G-net on (B, H, W, 3) RGB in [0, 1]: (depth, latent, feats)."""
    x = rgb_nhwc.permute(0, 3, 1, 2).float() * 2.0 - 1.0
    latent, skips = encoder(p, x, q)
    depth, feats = decoder(p, latent, skips, max_depth, q)
    return depth, latent, feats


def d_forward(p: Params, depth_nhwc, max_depth: float, q=quantizer("fp32")):
    """The D-net on (B, H, W, 1) metric depth: (recon, latent, feats)."""
    x = depth_nhwc.permute(0, 3, 1, 2).float() / max_depth
    latent, skips = encoder(p, x, q)
    recon, feats = decoder(p, latent, skips, max_depth, q)
    return recon, latent, feats


# -- the stage-2 loss --------------------------------------------------------

def _avgpool2(x):
    b, h, w = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :h2 * 2, :w2 * 2].reshape(b, h2, 2, w2, 2).mean(dim=(2, 4))


def gradient_loss(pred, gt, mask, scales: int):
    """Mean over ``scales`` of the masked L1 of forward differences; a
    coarse pixel is valid where its four children are."""
    total = 0.0
    for s in range(scales):
        if s > 0:
            pred = _avgpool2(pred)
            m_w = _avgpool2(mask)
            gt = _avgpool2(gt * mask) / torch.clamp(m_w, min=1e-6)
            mask = (m_w > 0.999).float()
        mdx = mask[:, :, 1:] * mask[:, :, :-1]
        mdy = mask[:, 1:, :] * mask[:, :-1, :]
        dx = (pred[:, :, 1:] - pred[:, :, :-1]) - (gt[:, :, 1:] - gt[:, :, :-1])
        dy = (pred[:, 1:, :] - pred[:, :-1, :]) - (gt[:, 1:, :] - gt[:, :-1, :])
        total = total + ((dx.abs() * mdx).sum() / torch.clamp(mdx.sum(), min=1.0)
                         + (dy.abs() * mdy).sum() / torch.clamp(mdy.sum(), min=1.0))
    return total / scales


def _blur_matrix(size: int, window: int, sigma: float, device) -> torch.Tensor:
    """(size, size) Gaussian blur along one axis, reflect-101 edges."""
    half = window // 2
    t = torch.arange(window, dtype=torch.float64) - (window - 1) / 2.0
    g = torch.exp(-t.square() / (2.0 * sigma ** 2))
    g = g / g.sum()
    m = torch.zeros((size, size), dtype=torch.float64)
    for i in range(size):
        for k in range(window):
            j = i + k - half
            j = -j if j < 0 else (2 * size - 2 - j if j >= size else j)
            m[i, j] += g[k]
    return m.float().to(device)


def ssim_loss(pred, gt, max_depth: float, valid, window: int, sigma: float):
    """(1 - mean SSIM) / 2 of depth over max depth, images with no valid
    pixel left out of the mean."""
    p, g = pred / max_depth, gt / max_depth
    my = _blur_matrix(p.shape[1], window, sigma, p.device)
    mx = _blur_matrix(p.shape[2], window, sigma, p.device)

    def blur(x):
        return torch.matmul(torch.matmul(my, x), mx.T)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = blur(p), blur(g)
    sx = torch.clamp(blur(p * p) - mu_x * mu_x, min=0.0)
    sy = torch.clamp(blur(g * g) - mu_y * mu_y, min=0.0)
    sxy = blur(p * g) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
        (mu_x * mu_x + mu_y * mu_y + c1) * (sx + sy + c2))
    mean = (s.mean(dim=(1, 2)) * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return (1.0 - mean) / 2.0


def stage2_loss(g_out, d_out, depth, mask, cfg: Dict):
    """The total stage-2 loss: masked L1, the multi-scale gradient term,
    SSIM and the guidance term (mean L1 of the latent and each decoder
    feature against the frozen D-net's), weighted as the config says."""
    lw = cfg["loss"]
    pred = g_out[0][:, 0]
    gt, m = depth[..., 0].float(), mask[..., 0].float()
    recon = (torch.abs(pred - gt) * m).sum() / torch.clamp(m.sum(), min=1.0)
    grad = gradient_loss(pred, gt, m, lw["grad_scales"])
    valid = (m.sum(dim=(1, 2)) > 0).float()
    ssim = ssim_loss(pred, gt, cfg["max_depth"], valid, lw["ssim_window"], lw["ssim_sigma"])
    pa = [g_out[1], *g_out[2]]
    pb = [d_out[1], *d_out[2]]
    latent = sum(torch.abs(a - b.detach()).mean() for a, b in zip(pa, pb)) / len(pa)
    return (lw["w_recon"] * recon + lw["w_grad"] * grad + lw["w_ssim"] * ssim
            + lw["w_latent"] * latent)


class Adam:
    """optax's adam: bias-corrected moments, eps outside the root."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def stage2_steps(g_params: Params, d_params: Params, batches, cfg: Dict,
                 precision: str = "fp32", rows: slice = slice(None)):
    """Follow stage 2 from ``g_params`` over ``batches`` (dicts of NHWC
    rgb, depth, mask), the G-net's decoder frozen.  ``rows``: the rows
    of each batch the step sees (a planted fault leaves half out).
    Returns the losses, the first step's gradient of each trained leaf
    and the trained leaves after the last step, all by name (the losses
    a list, the others dicts)."""
    q = quantizer(precision)
    tr = cfg["train"]
    g = {k: v.detach().clone().float() for k, v in g_params.items()}
    d = {k: v.detach().float() for k, v in d_params.items()}
    names = [k for k in g if k.startswith("encoder.")]
    for k in names:
        g[k].requires_grad_(True)
    opt = Adam([g[k] for k in names], tr["lr"], tr["beta1"], tr["beta2"], tr["eps"])
    losses, first = [], None
    md = cfg["max_depth"]
    for batch in batches:
        rgb, depth, mask = (batch[k][rows] for k in ("rgb", "depth", "mask"))
        with torch.no_grad():
            d_out = d_forward(d, depth, md, q)
        loss = stage2_loss(g_forward(g, rgb, md, q), d_out, depth, mask, cfg)
        grads = torch.autograd.grad(loss, [g[k] for k in names])
        if first is None:
            first = {k: gr.detach().clone() for k, gr in zip(names, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: g[k].detach() for k in names}


@torch.no_grad()
def predict_depth(g_params: Params, rgb_u8_nhwc, cfg: Dict, precision: str = "fp32",
                  block: int = 16) -> torch.Tensor:
    """The G-net's depth (N, H, W) in meters for uint8 RGB frames, in
    blocks of ``block`` frames."""
    q = quantizer(precision)
    g = {k: v.float() for k, v in g_params.items()}
    out = []
    for s in range(0, rgb_u8_nhwc.shape[0], block):
        rgb = rgb_u8_nhwc[s:s + block].float() / 255.0
        out.append(g_forward(g, rgb, cfg["max_depth"], q)[0][:, 0])
    return torch.cat(out)
