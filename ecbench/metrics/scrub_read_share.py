"""Share of the window's deep-scrub wall spent in the span reads (and
their CRC chains), the `read` stage of deep_scrub's stage_stats, %."""


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0:
        return None
    return 100.0 * sum(c["stats"].get("read", 0.0) for c in calls) / wall
