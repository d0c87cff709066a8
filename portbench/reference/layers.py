"""Plain float32 layers of the reference models, on NCHW tensors.

Parameters come as a flat ``{name: tensor}`` of the layouts the weights
file holds: conv kernels (kh, kw, cin, cout), BatchNorms'
``scale``/``bias``/``mean``/``var``.  ``lowp`` rounds a conv's input and
kernel before the conv: the identity for the reference, a lower precision
for the control (``fp8``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

DECODER = (320, 256, 128, 96, 64)  # the U-Nets' features per decoder stage
BN_EPS_DECODER = 1e-3


def identity(t):
    return t


def fp8(t):
    """``t`` scaled to float8 e4m3's range by its largest magnitude,
    rounded to float8 and back: the control's precision."""
    amax = t.abs().amax().float().clamp(min=1e-30)
    s = amax / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


PRECISIONS = {"f32": identity, "fp8": fp8}


class Shapes:
    """Collects ``name -> (shape, kind, fan-in scale)`` in declaration
    order; ``kind`` is kernel, bias, scale, shift, mean or var."""

    def __init__(self):
        self.items = OrderedDict()

    def conv(self, name, kh, kw, cin, cout, bias=True, scale=1.0):
        self.items[f"{name}.kernel"] = ((kh, kw, cin, cout), "kernel", scale)
        if bias:
            self.items[f"{name}.bias"] = ((cout,), "shift", 0.0)

    def bn(self, name, c):
        self.items[f"{name}.scale"] = ((c,), "scale", 0.0)
        self.items[f"{name}.bias"] = ((c,), "shift", 0.0)
        self.items[f"{name}.mean"] = ((c,), "shift", 0.0)
        self.items[f"{name}.var"] = ((c,), "scale", 0.0)


class Net:
    """A model's parameters ``P`` and precision ``lowp``, with the layers
    every reference model uses."""

    def __init__(self, P, lowp=identity):
        self.P = P
        self.lowp = lowp

    def conv(self, x, name, stride=1, padding=0):
        w = self.P[f"{name}.kernel"].permute(3, 2, 0, 1)  # OIHW
        y = F.conv2d(self.lowp(x), self.lowp(w), None, stride, padding)
        b = self.P.get(f"{name}.bias")
        return y if b is None else y + b[None, :, None, None]

    def bn(self, x, name, eps, relu):
        P = self.P
        mul = torch.rsqrt(P[f"{name}.var"] + eps) * P[f"{name}.scale"]
        y = (x - P[f"{name}.mean"][None, :, None, None]) * mul[
            None, :, None, None] + P[f"{name}.bias"][None, :, None, None]
        return torch.relu(y) if relu else y


def decoder_shapes(S: Shapes, c: int, skips):
    """The U-Net decoder's parameters, Keras-named from ``conv2d`` and
    ``batch_normalization`` on; ``skips`` deepest first."""
    def nm(base, i):
        return base if i == 0 else f"{base}_{i}"

    i = 0
    for feats, cs in zip(DECODER, list(skips) + [0]):
        for cin in (c, feats + cs):
            S.conv(nm("conv2d", i), 3, 3, cin, feats, scale=2.0)
            S.bn(nm("batch_normalization", i), feats)
            i += 1
        c = feats
    S.conv(nm("conv2d", i), 1, 1, c, 2)
    return i


def decode(net: Net, y, skips):
    """The decoder: per stage a nearest 2x upsample, conv block, the skip
    concatenated, conv block; a 1x1 head and the softmax's p(class 1)."""
    def nm(base, j):
        return base if j == 0 else f"{base}_{j}"

    i = 0
    for skip in list(skips) + [None]:
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        for part in (0, 1):
            if part == 1 and skip is not None:
                y = torch.cat([y, skip], 1)
            y = net.bn(net.conv(y, nm("conv2d", i), padding=1),
                       nm("batch_normalization", i), BN_EPS_DECODER, True)
            i += 1
    logits = net.conv(y, nm("conv2d", i))
    return torch.softmax(logits, 1)[:, 1]
