"""DenseNet-121 U-Net, plain float32 (Khened et al., arXiv:2001.00258).

Encoder: a 7x7 stride-2 stem conv, BN, relu and a 3x3 stride-2 max pool;
dense blocks of 6, 12, 24 and 16 layers (BN, relu, 1x1 conv to 128, BN,
relu, 3x3 conv to 32, concatenated), 0.5 transitions (BN, relu, 1x1 conv,
2x2 average pool) between them and a last BN without relu; BN eps
1.001e-5.  Decoder: the U-Net decoder of ``layers.py`` over the stem's and
the first three blocks' outputs.  Names are the Keras layers' names that
the weights file uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Net, Shapes, decode, decoder_shapes

BLOCKS = (6, 12, 24, 16)
GROWTH = 32
EPS = 1.001e-5


def shapes() -> Shapes:
    S = Shapes()
    S.conv("conv1__conv", 7, 7, 3, 64, bias=False)
    S.bn("conv1__bn", 64)
    c, skips = 64, [64]
    for bi, n in enumerate(BLOCKS):
        for i in range(n):
            ln = f"conv{bi + 2}_block{i + 1}"
            S.bn(f"{ln}_0_bn", c)
            S.conv(f"{ln}_1_conv", 1, 1, c, 4 * GROWTH, bias=False)
            S.bn(f"{ln}_1_bn", 4 * GROWTH)
            S.conv(f"{ln}_2_conv", 3, 3, 4 * GROWTH, GROWTH, bias=False)
            c += GROWTH
        if bi < len(BLOCKS) - 1:
            skips.append(c)
            S.bn(f"pool{bi + 2}_bn", c)
            S.conv(f"pool{bi + 2}_conv", 1, 1, c, c // 2, bias=False)
            c //= 2
    S.bn("bn", c)
    decoder_shapes(S, c, skips[::-1])
    return S


def forward(net: Net, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) normalized input -> (N, H, W) p(class 1)."""
    y = net.bn(net.conv(x, "conv1__conv", stride=2, padding=3), "conv1__bn",
               EPS, True)
    skips = [y]
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    for bi, n in enumerate(BLOCKS):
        for i in range(n):
            ln = f"conv{bi + 2}_block{i + 1}"
            h = net.bn(y, f"{ln}_0_bn", EPS, True)
            h = net.bn(net.conv(h, f"{ln}_1_conv"), f"{ln}_1_bn", EPS, True)
            y = torch.cat([y, net.conv(h, f"{ln}_2_conv", padding=1)], 1)
        if bi < len(BLOCKS) - 1:
            skips.append(y)
            y = net.conv(net.bn(y, f"pool{bi + 2}_bn", EPS, True),
                         f"pool{bi + 2}_conv")
            y = F.avg_pool2d(y, 2)
    y = net.bn(y, "bn", EPS, False)
    return decode(net, y, skips[::-1])
