"""Kernels per MD step on the first card in the traced window (chunk
graph replays and the eager evaluation of each report)."""
from cfbench.readers import kernels_per_step


def read(ctx):
    return kernels_per_step(ctx)
