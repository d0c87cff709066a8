"""The main thread's ``plan`` stage over the summed walls of the
window's slides, in percent."""


def read(ctx):
    return ctx.stage_share(("plan",))
