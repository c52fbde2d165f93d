"""Layer zoo: SE, DropBlock, EvoNorm and the language-free DyHead, in NCHW.

The PyTorch counterpart of `fiber_tpu/ops/layers_zoo.py` (the reference's
layers/se.py, dropblock.py, evonorm.py and the DyHead of its non-VL
configs).  `DropBlock2D` draws its block centres from an explicit
`torch.Generator`; `PlainDyHead` is the detection stack's `DyConv`
repeated (`dyhead_tower.{i}`).  Convs pad k // 2 on each side.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.detection.dyhead import DyConv


class SELayer(nn.Module):
    """Squeeze-and-excitation channel gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(1, channels // reduction)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


class SEBlock(nn.Module):
    """SE residual block: 1x1 reduce, 3x3, SE, 1x1 expand, + the input."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        mid = channels // reduction
        self.conv1 = nn.Conv2d(channels, mid, 1)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1)
        self.se = SELayer(mid)
        self.conv3 = nn.Conv2d(mid, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv2(F.relu(self.conv1(x))))
        return F.relu(x + self.conv3(self.se(y)))


class DropBlock2D(nn.Module):
    """Structured dropout: block_size x block_size regions around
    Bernoulli(gamma) centres are zeroed and the rest scaled by the kept
    share.  The identity in eval mode or at rate 0.  The centres come from
    `generator`."""

    def __init__(self, drop_prob: float, block_size: int = 7,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_prob, self.block_size = drop_prob, block_size
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.drop_prob == 0.0:
            return x
        B, C, H, W = x.shape
        bs = self.block_size
        gamma = (self.drop_prob / bs ** 2) * (H * W) / max(
            (H - bs + 1) * (W - bs + 1), 1)
        centers = (torch.rand(x.shape, device=x.device,
                              generator=self.generator) < gamma).float()
        # each centre grows into a block: a stride-1 max pool padded as
        # XLA's "SAME" (the larger half after)
        lo = (bs - 1) // 2
        block = F.max_pool2d(F.pad(centers, (lo, bs - 1 - lo, lo,
                                             bs - 1 - lo)), bs, 1)
        mask = 1.0 - block
        keep = mask.mean().clamp_min(1e-7)
        return x * mask.to(x.dtype) / keep.to(x.dtype)


class EvoNorm2d(nn.Module):
    """EvoNorm-S0: x sigmoid(v x) / group std * weight + bias (the std with
    Bessel's correction, plus eps); without the nonlinearity the affine
    alone."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5,
                 nonlinearity: bool = True):
        super().__init__()
        self.groups, self.eps, self.nonlinearity = groups, eps, nonlinearity
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        if nonlinearity:
            self.v = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()[:, None, None]
        b = self.bias.float()[:, None, None]
        if not self.nonlinearity:
            return x * w.to(x.dtype) + b.to(x.dtype)
        B, C, H, W = x.shape
        g = min(self.groups, C)
        xf = x.float()
        std = xf.reshape(B, g, -1).std(dim=-1, unbiased=True) + self.eps
        std = std[:, :, None].expand(B, g, C // g).reshape(B, C, 1, 1)
        num = xf * torch.sigmoid(self.v.float()[:, None, None] * xf)
        return (num / std * w + b).to(x.dtype)


class PlainDyHead(nn.Module):
    """The language-free DyHead tower: `n_convs` DyConvs (DyReLU, DyFuse
    and deformable convs on)."""

    def __init__(self, in_channels: int, channels: int, n_convs: int = 6):
        super().__init__()
        self.dyhead_tower = nn.ModuleList(
            DyConv(in_channels if i == 0 else channels, channels)
            for i in range(n_convs))

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        feats = list(features)
        for dyconv in self.dyhead_tower:
            feats = dyconv(feats)
        return feats
