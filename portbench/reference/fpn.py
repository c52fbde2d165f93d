"""FPN with RetinaNet's P6 / P7 levels, in NCHW: the reference's frozen
copy of `fiber_torch/detection/fpn.py` (lateral 1x1 convs, a nearest 2x
top-down path, 3x3 output convs, P6 and P7 as stride-2 3x3 convs off P5
with a ReLU before P7), the port's module names."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn
import torch.nn.functional as F

# the reference's index of the first tapped level (stride 8)
FIRST_LEVEL = 2


class LastLevelP6P7(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.p6 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        self.p7 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, p5: torch.Tensor) -> List[torch.Tensor]:
        p6 = self.p6(p5)
        return [p6, self.p7(F.relu(p6))]


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"fpn_inner{i + FIRST_LEVEL}",
                    nn.Conv2d(c, out_channels, 1))
            setattr(self, f"fpn_layer{i + FIRST_LEVEL}",
                    nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.top_blocks = LastLevelP6P7(out_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """feats: the backbone taps, NCHW, stride 8 first.  Returns the five
        levels P3..P7 (strides 8..128)."""
        lat = [getattr(self, f"fpn_inner{i + FIRST_LEVEL}")(f)
               for i, f in enumerate(feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + F.interpolate(lat[i + 1], scale_factor=2.0,
                                            mode="nearest")
        outs = [getattr(self, f"fpn_layer{i + FIRST_LEVEL}")(x)
                for i, x in enumerate(lat)]
        return outs + self.top_blocks(outs[-1])
