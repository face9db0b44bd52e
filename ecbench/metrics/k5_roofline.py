"""The deep scrub's parity step (parallel/mesh ParityStep, K1 form): the
least time the card's HBM allows for its K1 launches' bytes / their
device time in the trace, %."""

from ecbench.peaks import roofline_share


def read(ctx):
    return roofline_share(ctx, "k5", "gf_apply_kernel")
