"""The program's ``loader_wait`` span (the main thread blocked for the
loader's next batch) over the slide's wall, in percent, mean over the
window's slides."""

from portbench.timings import mean_share


def read(ctx):
    return mean_share(ctx, ("loader_wait",))
