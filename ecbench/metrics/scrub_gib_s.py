"""Shard bytes deep-scrubbed in the window / the window's seconds (the
last call runs to its end, and so does the window), GiB/s."""


def read(ctx):
    if not ctx.get("scrub_s"):
        return None
    return ctx["scrub_bytes"] / float(1 << 30) / ctx["scrub_s"]
