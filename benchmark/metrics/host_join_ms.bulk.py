"""The host's time joining a bulk call's answers, ms: the median of the
program's untraced ``gdn.predict.join`` spans in
``serving.BatchedPredictor.predict`` (one array of the call's depth maps,
after the last fetch; the card idles through it)."""

from harness.spans import bulk_units, median_ms


def read(ctx):
    if ctx.get("kind") != "bulk":
        return None
    calls, _ = bulk_units(ctx)
    return median_ms("gdn.predict.join", calls)
