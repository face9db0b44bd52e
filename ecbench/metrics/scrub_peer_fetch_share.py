"""Share of the window's deep-scrub wall the source server's threads
spent fetching shard spans from peers: the window delta of
SeaweedFS_volumeServer_ec_peer_read_seconds_total{qos_class="background"}
(summed over the fetching threads, so worker-seconds that may pass 100%)
over the window calls' wall, %.  None where the program has no such
counter."""

from ecbench.expo import delta

NAME = "SeaweedFS_volumeServer_ec_peer_read_seconds_total"


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0 or not any(k[0] == NAME for k in ctx["after"]["expo"]):
        return None
    return 100.0 * delta(ctx, NAME, qos_class="background") / wall
