"""Shard bytes deep-scrubbed in the window / the window's seconds (the
last call runs to its end, and so does the window), GiB/s: the scrub's
whole rate on the host clock, which the host's speed moves by more than
any bound could hold (it was the end-to-end `scrub_gib_s` until the card
time per GiB took its place)."""


def read(ctx):
    if not ctx.get("scrub_s"):
        return None
    return ctx["scrub_bytes"] / float(1 << 30) / ctx["scrub_s"]
