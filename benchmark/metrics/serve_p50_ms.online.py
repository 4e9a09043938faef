"""The median latency of the window's requests, due time to depth on
the host (a missing answer counts as slower than any)."""

from harness.core import percentile


def read(ctx):
    if ctx.get("kind") != "online":
        return None
    return percentile(ctx["latencies_ms"], 50)
