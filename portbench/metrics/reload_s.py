"""Mean seconds a slide of the program's ``build``, ``load`` and
``to_device`` spans: each model's build, its weights' read and their
copy to the card."""

from portbench.timings import mean_seconds


def read(ctx):
    return mean_seconds(ctx, ("build", "load", "to_device"))
