"""Seconds from the start of the benchmark's process to the first timed
operation: traffic generation, the kernels' and host library's build or
load, and the warm-up calls (host clock)."""


def read(ctx):
    return ctx.setup_s
