"""The median over the window's deep_scrub calls of each call's shard
bytes / its seconds, GiB/s: a rate that a few stalled calls do not move,
beside the window's whole rate (`scrub_window_gib_s`).  None without the
calls' own seconds."""

import statistics


def read(ctx):
    rates = [c["bytes"] / float(1 << 30) / c["s"]
             for c in ctx.get("window_calls") or () if c.get("s")]
    return statistics.median(rates) if rates else None
