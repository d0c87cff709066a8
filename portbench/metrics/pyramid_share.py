"""The program's ``write.pyramid`` spans (the three JPEG pyramid writes)
over the slide's wall, in percent, mean over the window's slides."""

from portbench.timings import mean_share


def read(ctx):
    return mean_share(ctx, ("write.pyramid",))
