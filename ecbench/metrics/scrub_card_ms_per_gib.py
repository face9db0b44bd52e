"""Milliseconds the card was busy per GiB of shards the window's
deep_scrub calls checked, ms/GiB: the union of kernel, copy and memset
intervals in torch.profiler's CUPTI trace of the window (every run on the
card takes it), over the shard bytes of the calls that ran in it.  The
card time a deep scrub takes from the node's other card work (degraded
reads, encodes, rebuilds).  None without a trace (a run on the CPU)."""


def read(ctx):
    tl = ctx.get("trace")
    gib = ctx.get("scrub_bytes", 0) / float(1 << 30)
    if not tl or gib <= 0 or tl["busy_s"] <= 0:
        return None
    return 1e3 * tl["busy_s"] / gib
