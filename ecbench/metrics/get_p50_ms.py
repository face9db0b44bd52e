"""Median latency of the window's GETs, ms, from each request's due time
(open loop)."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
