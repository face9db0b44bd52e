"""100 x (1 - union of kernel, copy and memset intervals on the card /
the traced window), from torch.profiler's CUPTI trace, %."""


def read(ctx):
    tl = ctx.get("trace")
    if not tl or tl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
