"""Mean time the volume server spent in a needle read over the window,
ms: SeaweedFS_volumeServer_request_seconds{type="read"} sum / count
deltas."""

from ecbench.expo import delta

NAME = "SeaweedFS_volumeServer_request_seconds"


def read(ctx):
    n = delta(ctx, NAME + "_count", type="read")
    if n <= 0:
        return None
    return 1e3 * delta(ctx, NAME + "_sum", type="read") / n
