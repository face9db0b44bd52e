"""Mean time the peers spent serving a shard span in the window, ms:
SeaweedFS_rpc_hop_seconds{route="/admin/ec/shard_read"} sum / count
deltas, summed over the peers' own expositions (read over /metrics at
the window's open and close); a request's time in the peer's dispatch,
from its routing to its reply written.  None without peers."""

from ecbench.expo import value

NAME = "SeaweedFS_rpc_hop_seconds"
ROUTE = "/admin/ec/shard_read"


def _delta(ctx, sample):
    if "peer_expo" not in ctx["after"]:
        return 0.0
    return (value(ctx["after"]["peer_expo"], sample, route=ROUTE)
            - value(ctx["before"]["peer_expo"], sample, route=ROUTE))


def read(ctx):
    n = _delta(ctx, NAME + "_count")
    if n <= 0:
        return None
    return 1e3 * _delta(ctx, NAME + "_sum") / n
