"""The program's ``flush_wait`` span (the main thread blocked on a
supertile's background flush) over the slide's wall, in percent, mean
over the window's slides."""

from portbench.timings import mean_share


def read(ctx):
    return mean_share(ctx, ("flush_wait",))
