"""The host's time launching a bulk batch, ms: the median of the
program's untraced ``gdn.predict.launch`` spans in
``serving.BatchedPredictor.predict`` (the upload, the forward's launches,
the device-to-host copy and its event)."""

from harness.spans import bulk_units, median_ms


def read(ctx):
    if ctx.get("kind") != "bulk":
        return None
    _, batches = bulk_units(ctx)
    return median_ms("gdn.predict.launch", batches)
