"""A small 2-stage U-Net for tests (``digipathai_tpu/models/tiny_unet.py``).

Its five 3x3 convs run through ``fused_conv3x3`` (conv + bias + relu), so
the CPU engine tests go through the kernel module's dispatch.  Submodules
carry flax's auto-names ``Conv_0`` .. ``Conv_5``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv_fused
from .unet_decoder import Conv, conv1x1, upsample2x


class TinyUNet(nn.Module):
    def __init__(self, num_classes: int = 2, width: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        w = width
        for i, (cin, cout) in enumerate([(3, w), (w, 2 * w), (2 * w, 4 * w),
                                         (6 * w, 2 * w), (3 * w, w)]):
            self.add_module(f"Conv_{i}", Conv(3, 3, cin, cout))
        self.Conv_5 = Conv(1, 1, w, num_classes)

    def _conv(self, x, i):
        c = getattr(self, f"Conv_{i}")
        return conv_fused.fused_conv3x3(x, c.kernel, c.bias)

    @staticmethod
    def _pool(x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(
            0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        e1 = self._conv(x, 0)
        e2 = self._conv(self._pool(e1), 1)
        b = self._conv(self._pool(e2), 2)
        u2 = self._conv(torch.cat([upsample2x(b), e2], dim=-1), 3)
        u1 = self._conv(torch.cat([upsample2x(u2), e1], dim=-1), 4)
        return torch.softmax(conv1x1(u1, self.Conv_5).float(), dim=-1)
