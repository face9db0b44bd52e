"""Share of the window's deep-scrub wall spent zeroing the pinned stage
and copying the data spans into it, the `stage_fill` + `stage_copy`
timers of deep_scrub's stage_stats, %.  None where the program keeps no
such timers."""

KEYS = ("stage_fill", "stage_copy")


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0 or not any(k in c["stats"] for c in calls for k in KEYS):
        return None
    return 100.0 * sum(c["stats"].get(k, 0.0)
                       for c in calls for k in KEYS) / wall
