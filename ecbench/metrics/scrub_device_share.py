"""Share of the window's deep-scrub wall that the card spent on the
scrub's H2D copies, parity step and D2H copies, as the CUDA events
recorded around them measure it (`device_h2d` + `device_kernel` +
`device_d2h` of deep_scrub's stage_stats), %.  None where the program
records no such events (on the CPU, or without the timers)."""

KEYS = ("device_h2d", "device_kernel", "device_d2h")


def read(ctx):
    calls = ctx.get("window_calls") or []
    wall = sum(c["stats"].get("wall", 0.0) for c in calls)
    if wall <= 0 or not any(k in c["stats"] for c in calls for k in KEYS):
        return None
    return 100.0 * sum(c["stats"].get(k, 0.0)
                       for c in calls for k in KEYS) / wall
