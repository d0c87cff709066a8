"""The conv kernel (``csrc/conv_fused.cu``) against its roofline over the
traced slide, in percent: the least time of every launch the cell's
forwards need (``work.bound`` of ``work.conv_work``, bf16) over the device
time of the kernels its wrapper launched.  Nothing is reported where the
traced slide's launch count differs from the forwards' shapes."""

from portbench import roofline, work


def read(ctx):
    return roofline.share(ctx, "fused_conv3x3",
                          lambda s: work.bound(*work.conv_work(*s), "bf16"))
