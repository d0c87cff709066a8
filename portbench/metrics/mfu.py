"""The FLOPs the cell's forwards need (planned patches x transforms x
each model's FLOPs, counted on the reference models), over the window's
seconds x 989 TFLOP/s (bf16 peak), in percent."""

from portbench.work import PEAK_FLOPS


def read(ctx):
    return (100.0 * ctx.flops_per_slide * len(ctx.slides)
            / (ctx.window_s * PEAK_FLOPS["bf16"]))
