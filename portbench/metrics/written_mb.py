"""Mean megabytes (1e6 bytes) a slide of the program's ``bytes_written``
counter: the files each call creates or rewrites (its maps, 8-bit scratch
maps, pyramids and state file)."""

from portbench.timings import mean_counter


def read(ctx):
    n = mean_counter(ctx, "bytes_written")
    return None if n is None else n / 1e6
