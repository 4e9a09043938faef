"""Kernels launched a training step: the kernel rows of the traced
slice over its steps (the batch draw, the step and the loop's work)."""


def read(ctx):
    sl = ctx.get("slice")
    if ctx.get("kind") != "train" or sl is None:
        return None
    return sl.kernels()[1] / ctx["slice_units"]
