"""Planned stride-128 tissue patches of every slide completed in the
window, over the window's wall time."""


def read(ctx):
    return ctx.planned_patches * len(ctx.slides) / ctx.window_s
