"""The share of one steady traced slide's wall (a slide after the window)
in which no kernel ran on the card, in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall)
