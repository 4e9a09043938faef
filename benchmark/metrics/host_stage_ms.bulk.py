"""The host's time staging a bulk batch, ms: the median of the
program's untraced ``gdn.predict.stage`` spans in
``serving.BatchedPredictor.predict`` (the pad, ``from_numpy`` and the
pinned copy of the batch's frames)."""

from harness.spans import bulk_units, median_ms


def read(ctx):
    if ctx.get("kind") != "bulk":
        return None
    _, batches = bulk_units(ctx)
    return median_ms("gdn.predict.stage", batches)
