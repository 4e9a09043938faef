"""Kernels launched a predictor batch: the kernel rows of the traced
slice (one ``predict`` call) over its batches."""


def read(ctx):
    sl = ctx.get("slice")
    if ctx.get("kind") != "bulk" or sl is None:
        return None
    return sl.kernels()[1] / (ctx["slice_units"] / ctx["batch"])
