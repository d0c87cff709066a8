"""Parameter-free 'oracle' model for engine tests (``digipathai_tpu/models/oracle.py``).

Dark pixels -> class 1: the correct segmentation of a synthetic slide is
known analytically, so the engine can be checked without trained weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class OracleDarkness(nn.Module):
    def __init__(self, pivot: float = -0.1, sharpness: float = 20.0,
                 dtype=torch.float32):
        super().__init__()
        self.pivot = pivot          # brightness in (x-128)/128 units
        self.sharpness = sharpness
        self.dtype = dtype          # accepted for uniformity; output is f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        brightness = x.float().mean(dim=-1)
        p1 = torch.sigmoid((self.pivot - brightness) * self.sharpness)
        return torch.stack([1.0 - p1, p1], dim=-1)
