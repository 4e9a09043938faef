"""The whole stage-2 step's share of the bf16 peak: the benchmark's
count of a step's operations (``roofline.work.stage2_step_flops``) times
the window's steps, over the window's host-clock seconds, over 989
TFLOP/s."""

from roofline.work import BF16_FLOPS, stage2_step_flops


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    flops = stage2_step_flops(ctx["cfg"], ctx["batch"]) * ctx["window_units"]
    return 100.0 * flops / ctx["window_s"] / BF16_FLOPS
