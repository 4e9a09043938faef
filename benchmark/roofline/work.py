"""The benchmark's yardstick for operations and bytes: the published
peaks of one H100 and the work of the guided depth net's layers,
counted from a configuration's shapes alone.

Nothing here reads the program: a later change that fuses, splits or
reorders kernels leaves these counts where they are.

Convolutions: 2 operations a multiply-add, at the output resolution of
an XLA "SAME" convolution, the 7x7 stem at its input channels, the
concat fusion convs at their concatenated widths, the up-conv as the
3x3 conv on the upsampled map (the algorithm the net states; the port's
composed transposed conv computes the same products).  GroupNorm,
activations, resizes and the loss are left out of the whole-step count
(under 1% of it at these widths).

A stage-2 step is the frozen D-net's forward, the G-net's forward and
the G-net's backward.  The backward computes, for each encoder conv, the
weight gradient and the input gradient (2x its forward), except the
stem's input gradient (RGB takes none); for each decoder conv (its
weights frozen, the head's too) the input gradient only (1x its
forward).

``gn_work``, ``loss_work`` and ``bound_ms`` are copies of
``chip_smoke.py``'s functions of the same names, with their constants.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

# NVIDIA H100 SXM data sheet: dense rates without sparsity, 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores

GN_FLOPS_PER_ELEM = 8  # sum, square-sum, center, scale, shift, ELU
# Fused loss operation counts per pixel for an 11-tap window (see
# chip_smoke.py): forward = 3 products + 5 moments x 2 passes x 11 taps
# x 2 + ~20 for the SSIM map + 16 for L1 and the two differences + 2
# normalizations; backward = the same moments (225) + ~35 for the map
# and the three adjoint maps + 3 maps x 2 passes x 11 taps x 2 for the
# transposed blur + ~35 for the sign fields and the final sum.
LOSS_FWD_FLOPS_PX = 3 + 5 * 2 * 11 * 2 + 20 + 16 + 2
LOSS_BWD_FLOPS_PX = 225 + 35 + 3 * 2 * 11 * 2 + 35
LOSS_FWD_BYTES_PX = 12  # pred, gt, mask read (fp32)
LOSS_BWD_BYTES_PX = 16  # the same, plus dpred written


class Site(NamedTuple):
    """One convolution of a net: where it is, its widths and output size,
    and whether a GroupNorm+ELU epilogue follows it."""
    name: str
    part: str  # "encoder" | "decoder"
    cin: int
    cout: int
    k: int
    ho: int
    wo: int
    gn: bool


def level_sizes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """(H, W) of the input and of each stride-2 SAME level below it."""
    out = [(h, w)]
    for _ in range(levels):
        h, w = math.ceil(h / 2), math.ceil(w / 2)
        out.append((h, w))
    return out


def net_sites(cfg: Dict, in_channels: int) -> List[Site]:
    """Every convolution of a D-net (``in_channels`` 1) or G-net (3) of
    the configuration ``cfg`` (the JSON of ``benchmark/configs``)."""
    h, w = cfg["image_size"]
    enc, dec = cfg["enc_channels"], cfg["dec_channels"]
    sizes = level_sizes(h, w, len(enc))
    sites = [Site("stem", "encoder", in_channels, enc[0], 7, h, w, True)]
    cin = enc[0]
    for i, ch in enumerate(enc):
        ho, wo = sizes[i + 1]
        sites.append(Site(f"down{i}.s2", "encoder", cin, ch, 3, ho, wo, True))
        sites.append(Site(f"down{i}.refine", "encoder", ch, ch, 3, ho, wo, True))
        cin = ch
    skips = [enc[0], *enc[:-1]]  # skip channels, fine -> coarse
    m = len(skips)
    for i, ch in enumerate(dec):
        lat = skips[m - 1 - i]
        ho, wo = sizes[m - 1 - i]
        sites.append(Site(f"up{i}.up", "decoder", cin, ch, 3, ho, wo, True))
        sites.append(Site(f"up{i}.fuse", "decoder", ch + lat, ch, 3, ho, wo, True))
        cin = ch
    sites.append(Site("head", "decoder", cin, 1, 3, h, w, False))
    return sites


def conv_flops(s: Site, batch: int) -> float:
    return 2.0 * s.k * s.k * s.cin * s.cout * s.ho * s.wo * batch


def forward_flops(cfg: Dict, in_channels: int, batch: int) -> float:
    """Operations of one forward of ``batch`` images."""
    return sum(conv_flops(s, batch) for s in net_sites(cfg, in_channels))


def stage2_step_flops(cfg: Dict, batch: int) -> float:
    """Operations of one stage-2 step of ``batch`` images (see the module
    docstring): D forward, G forward, G backward with a frozen decoder."""
    g = net_sites(cfg, 3)
    bwd = 0.0
    for s in g:
        f = conv_flops(s, batch)
        if s.part == "decoder":
            bwd += f
        elif s.name == "stem":
            bwd += f  # the weight gradient only
        else:
            bwd += 2 * f
    return forward_flops(cfg, 1, batch) + forward_flops(cfg, 3, batch) + bwd


def gn_work(shape, item):
    """(flops, bytes) of one GroupNorm+ELU call on x of ``shape`` (B, C,
    H, W) with ``item`` bytes an element: GN_FLOPS_PER_ELEM a element;
    x read once, the output written once (x's dtype), the fp32 scale and
    bias read once."""
    b, c, h, w = shape
    numel = b * c * h * w
    return GN_FLOPS_PER_ELEM * numel, 2 * numel * item + 2 * c * 4


def loss_work(b, h, w):
    """{"fwd" | "bwd": (flops, bytes)} of one fused loss call on (b, h, w)
    fp32 maps, by the per-pixel counts above."""
    px = b * h * w
    return {"fwd": (LOSS_FWD_FLOPS_PX * px, LOSS_FWD_BYTES_PX * px),
            "bwd": (LOSS_BWD_FLOPS_PX * px, LOSS_BWD_BYTES_PX * px)}


def bound_ms(flops, nbytes):
    """The least time of fp32 work on the card: bytes at the memory rate
    or operations at the fp32 peak, whichever is longer."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def gn_bound_ms(cfg: Dict, in_channels: int, batch: int, item: int) -> float:
    """The least time of the GroupNorm+ELU forwards of one net's sites."""
    return sum(bound_ms(*gn_work((batch, s.cout, s.ho, s.wo), item))
               for s in net_sites(cfg, in_channels) if s.gn)


def stage2_gn_bound_ms(cfg: Dict, batch: int, item: int = 2) -> float:
    """A stage-2 step's GroupNorm+ELU forwards: the D-net's and the
    G-net's sites, once each (their backward is not this kernel's)."""
    return gn_bound_ms(cfg, 1, batch, item) + gn_bound_ms(cfg, 3, batch, item)


def stage2_loss_bound_ms(cfg: Dict, batch: int) -> float:
    """A stage-2 step's fused loss, forward and backward, at full size."""
    h, w = cfg["image_size"]
    work = loss_work(batch, h, w)
    return bound_ms(*work["fwd"]) + bound_ms(*work["bwd"])
