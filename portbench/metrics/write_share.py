"""The main thread's ``finalize`` and ``write`` stages (the maps' final
division and the three pyramid writes) over the summed walls of the
window's slides, in percent."""


def read(ctx):
    return ctx.stage_share(("finalize", "write"))
