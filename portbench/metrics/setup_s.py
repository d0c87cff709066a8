"""Seconds from the process's start to the first timed call: imports, the
kernels' build where the checkout has none, the slides, the weights and
the warm-up slide."""


def read(ctx):
    return ctx.setup_s
