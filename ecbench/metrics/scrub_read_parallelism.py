"""Mean number of busy workers in the window's deep-scrub read stages:
the tasks' own seconds (`read_busy` of deep_scrub's stage_stats) over
the caller's wait for them (`read`), x.  None where the program keeps no
`read_busy` (a read stage without a pool of workers)."""


def read(ctx):
    calls = ctx.get("window_calls") or []
    if not any("read_busy" in c["stats"] for c in calls):
        return None
    wait = sum(c["stats"].get("read", 0.0) for c in calls)
    if wait <= 0:
        return None
    return sum(c["stats"].get("read_busy", 0.0) for c in calls) / wait
