"""Share of the window's deep-scrub wall spent chaining each read span
into its shard's CRC32C, the `span_crc` timer of deep_scrub's
stage_stats, %.  None where the program keeps no such timer."""

KEYS = ("span_crc",)


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0 or not any(k in c["stats"] for c in calls for k in KEYS):
        return None
    return 100.0 * sum(c["stats"].get(k, 0.0)
                       for c in calls for k in KEYS) / wall
