"""Share of the window's deep-scrub span bytes that a target's `read_into`
filled into the pinned stage in place: `read_direct_bytes /
(read_direct_bytes + read_copied_bytes)` of deep_scrub's stage_stats,
summed over the window's calls, %.  None where the program keeps no such
counts."""

KEYS = ("read_direct_bytes", "read_copied_bytes")


def read(ctx):
    calls = ctx.get("window_calls") or []
    if not any(KEYS[0] in c["stats"] for c in calls):
        return None
    direct = sum(c["stats"].get(KEYS[0], 0) for c in calls)
    copied = sum(c["stats"].get(KEYS[1], 0) for c in calls)
    if direct + copied <= 0:
        return None
    return 100.0 * direct / (direct + copied)
