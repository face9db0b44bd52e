"""Share of the window's deep-scrub wall spent finalizing the CRC32C
images that K8 took on the card of each batch's 4 recomputed parity rows
and chaining them into each parity shard's recomputed CRC, on the caller's
thread, the `parity_crc` timer of deep_scrub's stage_stats, %.  None where
the program keeps no such timer."""

KEYS = ("parity_crc",)


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0 or not any(k in c["stats"] for c in calls for k in KEYS):
        return None
    return 100.0 * sum(c["stats"].get(k, 0.0)
                       for c in calls for k in KEYS) / wall
