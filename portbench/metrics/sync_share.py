"""The program's ``finalize.sync`` and ``write.sync`` spans (the memmaps'
flush to their files) over the slide's wall, in percent, mean over the
window's slides."""

from portbench.timings import mean_share


def read(ctx):
    return mean_share(ctx, ("finalize.sync", "write.sync"))
