"""The whole G-net forward's share of the bf16 peak while serving in
bulk: the benchmark's count of one image's forward
(``roofline.work.forward_flops``) times the images answered in the
window, over its host-clock seconds, over 989 TFLOP/s."""

from roofline.work import BF16_FLOPS, forward_flops


def read(ctx):
    if ctx.get("kind") != "bulk":
        return None
    flops = forward_flops(ctx["cfg"], 3, 1) * ctx["window_units"]
    return 100.0 * flops / ctx["window_s"] / BF16_FLOPS
