"""Share of the window's deep-scrub wall spent finalizing the CRC32C
images that K8 took on the card of each batch's 14 staged shard rows and
chaining them into each shard file's CRC, on the caller's thread (in the
inline sweep of a target that cannot recompute: its host CRC32C), the
`span_crc` timer of deep_scrub's stage_stats, %.  None where the program
keeps no such timer."""

KEYS = ("span_crc",)


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0 or not any(k in c["stats"] for c in calls for k in KEYS):
        return None
    return 100.0 * sum(c["stats"].get(k, 0.0)
                       for c in calls for k in KEYS) / wall
