"""Share of the window's deep-scrub wall spent waiting for each batch's
parity and chaining its CRCs, the `encode_crc` stage of deep_scrub's
stage_stats, %."""


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0:
        return None
    return 100.0 * sum(c["stats"].get("encode_crc", 0.0) for c in calls) / wall
