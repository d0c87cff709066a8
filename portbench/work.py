"""What the work of a cell costs at the least: operations, bytes and the
time the card needs for them.

Peaks are the NVIDIA H100 SXM data sheet's dense rates at 700 W: 989
TFLOP/s in bf16 and 3.35 TB/s of HBM.  A kernel's least time is the larger of its operations over the
peak and its bytes over the bandwidth, each input, weight and output
counted once.  ``bound`` and ``conv_work`` are the arithmetic of the
repository's ``chip_smoke.py`` (``bound`` and its conv rows), frozen
here.
"""

from __future__ import annotations

from .reference import layers

PEAK_FLOPS = {"bf16": 989e12}
HBM_BPS = 3.35e12


def bound(flop: float, nbytes: float, kind: str) -> float:
    """Seconds the card needs at the least."""
    return max(flop / PEAK_FLOPS[kind], nbytes / HBM_BPS)


def conv_work(n, h, w, c, f, itemsize=2):
    """(FLOP, bytes) of a 3x3 SAME conv over (n, h, w, c) to f channels."""
    flop = 2.0 * n * h * w * 9 * c * f
    return flop, float(itemsize * (n * h * w * c + 9 * c * f + n * h * w * f))


def decoder_convs(n, side, c, skips):
    """The 3x3 conv blocks of the U-Net decoder of an (n, side, side) input
    with ``c`` channels at side / 32 and ``skips`` (deepest first), as
    (n, h, w, cin, f)."""
    convs, r = [], side // 32
    for feats, cs in zip(layers.DECODER, list(skips) + [0]):
        convs += [(n, 2 * r, 2 * r, c, feats),
                  (n, 2 * r, 2 * r, feats + cs, feats)]
        r, c = 2 * r, feats
    return convs


#: the U-Nets' encoder output channels and skips (deepest first)
UNETS = {"dense": (1024, (1024, 512, 256, 64))}


def unet_kernels(model, n, side, blocks=(6, 12, 24, 16), growth=32):
    """The (n, h, w, cin, f) of each launch one forward of ``model`` makes
    on the program's conv kernel: the DenseNet's dense-layer 3x3 convs
    (its other convs are cuDNN's) and the decoder's."""
    convs = []
    if model == "dense":
        r = side // 4
        for bi, nl in enumerate(blocks):
            convs += [(n, r, r, 4 * growth, growth)] * nl
            r //= 2 if bi < len(blocks) - 1 else 1
    c, skips = UNETS[model]
    return convs + decoder_convs(n, side, c, skips)


def model_flops(module, side: int) -> float:
    """FLOPs of one (1, 3, side, side) forward of a reference model
    (convolutions and matrix products, as ``FlopCounterMode`` counts them),
    on the meta device: no memory, no time."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    P = {k: torch.empty(v[0], device="meta")
         for k, v in module.shapes().items.items()}
    x = torch.empty((1, 3, side, side), device="meta")
    with FlopCounterMode(display=False) as fc:
        module.forward(layers.Net(P), x)
    return float(fc.get_total_flops())
