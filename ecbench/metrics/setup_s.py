"""Seconds from the process's start to the window's: imports, data made
from the seed, the encode, servers up, kernels loaded, warm-up."""


def read(ctx):
    return ctx["setup_s"]
