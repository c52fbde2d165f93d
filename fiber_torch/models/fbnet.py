"""FBNet mobile trunk (the inverted-residual search space), in NCHW.

The PyTorch counterpart of `fiber_tpu/models/fbnet.py`: `IRFBlock` (1x1
expand, an optional channel shuffle, depthwise conv or two cascaded,
1x1 linear, residual, SE), the block-op table `PRIMITIVES`, the arch
tables `ARCH_DEFS` and `FBNetTrunk`, with GroupNorm (gcd(32, C) groups,
flax's eps 1e-6) in place of BatchNorm, as the JAX package redesigned
it.  Convs pad k // 2 on each side.  Module names are the JAX package's:
`stem.{conv,norm}`, `stages.{s}.{b}.{pw,dw,dw2,pwl}.{conv,norm}`,
`stages.{s}.{b}.se.{fc1,fc2}`.  The trunk takes NHWC images and returns
the NCHW taps of its last three stages (strides 8, 16, 32).
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.models.backbone_zoo import group_norm


def _get_divisible_by(num: float, divisor: int) -> int:
    """The reference's rounding (Python 2's round half away)."""
    ret = int(num)
    if divisor > 0 and ret % divisor != 0:
        ret = int((math.floor(num / divisor + 0.5) or divisor) * divisor)
    return ret


class ConvNormRelu(nn.Module):
    """Conv (no bias, padding k // 2), GroupNorm and an optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, relu: bool = True,
                 use_norm: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=kernel // 2, groups=groups, bias=False)
        self.norm = group_norm(out_ch) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.relu else x


class SEModule(nn.Module):
    """Squeeze-excite with a /4 reduction (at least 8)."""

    def __init__(self, channels: int):
        super().__init__()
        mid = max(channels // 4, 8)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Interleave the channels of `groups` groups (NCHW)."""
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2).reshape(
        B, C, H, W)


class IRFBlock(nn.Module):
    """Inverted residual: pw, (shuffle), dw (and dw2 when cascaded), pwl,
    + the input when the shape holds, then SE."""

    def __init__(self, in_ch: int, out_ch: int, expansion: float,
                 stride: int, kernel: int = 3, se: bool = False,
                 cdw: bool = False, shuffle_mid: bool = False,
                 pw_group: int = 1, width_divisor: int = 1):
        super().__init__()
        mid = _get_divisible_by(in_ch * expansion, width_divisor)
        self.shuffle = pw_group if shuffle_mid else 0
        self.residual = stride == 1 and in_ch == out_ch
        self.pw = ConvNormRelu(in_ch, mid, 1, groups=pw_group)
        self.dw = self.dw2 = None
        if kernel > 1:
            self.dw = ConvNormRelu(mid, mid, kernel, stride, groups=mid)
            if cdw:
                self.dw2 = ConvNormRelu(mid, mid, kernel, 1, groups=mid)
        self.pwl = ConvNormRelu(mid, out_ch, 1, groups=pw_group, relu=False)
        self.se = SEModule(out_ch) if se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw(x)
        if self.shuffle:
            y = channel_shuffle(y, self.shuffle)
        if self.dw is not None:
            y = self.dw(y)
        if self.dw2 is not None:
            y = self.dw2(y)
        y = self.pwl(y)
        if self.residual:
            y = y + x
        return self.se(y) if self.se is not None else y


class Skip(nn.Module):
    """The identity, or a 1x1 conv where the shape changes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv = (None if in_ch == out_ch and stride == 1 else
                     ConvNormRelu(in_ch, out_ch, 1, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.conv is None else self.conv(x)


# block op -> (expansion, kernel, se, cdw, shuffle_mid, pw_group)
PRIMITIVES = {
    "ir_k3_e1": (1, 3, False, False, False, 1),
    "ir_k3_e3": (3, 3, False, False, False, 1),
    "ir_k3_e6": (6, 3, False, False, False, 1),
    "ir_k3_s2": (1, 3, False, False, True, 2),
    "ir_k3_s4": (4, 3, False, False, True, 4),
    "ir_k5_e1": (1, 5, False, False, False, 1),
    "ir_k5_e3": (3, 5, False, False, False, 1),
    "ir_k5_e6": (6, 5, False, False, False, 1),
    "ir_k5_s2": (1, 5, False, False, True, 2),
    "ir_k5_s4": (4, 5, False, False, True, 4),
    "ir_k7_e1": (1, 7, False, False, False, 1),
    "ir_k7_e3": (3, 7, False, False, False, 1),
    "ir_k7_e6": (6, 7, False, False, False, 1),
    "ir_k33_e1": (1, 3, False, True, False, 1),
    "ir_k33_e3": (3, 3, False, True, False, 1),
    "ir_k33_e6": (6, 3, False, True, False, 1),
    "ir_k7_sep_e1": (1, 7, False, True, False, 1),
    "ir_k7_sep_e3": (3, 7, False, True, False, 1),
    "ir_k7_sep_e6": (6, 7, False, True, False, 1),
}
PRIMITIVES.update({f"{k}_se": (e, ker, True, cdw, sh, g)
                   for k, (e, ker, _, cdw, sh, g) in list(PRIMITIVES.items())})

# stage tables of (op, out_channels, stride, repeats); a stage's first
# block takes the stride
ARCH_DEFS = {
    "default": [
        [("ir_k3_e1", 16, 1, 1)],
        [("ir_k3_e6", 24, 2, 2)],
        [("ir_k3_e6", 32, 2, 3)],
        [("ir_k3_e6", 64, 2, 4), ("ir_k3_e6", 96, 1, 3)],
        [("ir_k3_e6", 160, 2, 3), ("ir_k3_e6", 320, 1, 1)],
    ],
    "fbnet_c": [
        [("ir_k3_e1", 16, 1, 1)],
        [("ir_k3_e6", 24, 2, 1), ("ir_k3_e1", 24, 1, 3)],
        [("ir_k5_e6", 32, 2, 1), ("ir_k5_e3", 32, 1, 1),
         ("ir_k5_e6", 32, 1, 1), ("ir_k3_e6", 32, 1, 1)],
        [("ir_k5_e6", 64, 2, 1), ("ir_k5_e3", 64, 1, 1),
         ("ir_k5_e6", 64, 1, 2), ("ir_k5_e6", 112, 1, 1),
         ("ir_k5_e3", 112, 1, 1), ("ir_k5_e6", 112, 1, 2)],
        [("ir_k5_e6", 184, 2, 1), ("ir_k5_e6", 184, 1, 3),
         ("ir_k3_e6", 352, 1, 1)],
    ],
}


def tap_channels(arch: str) -> List[int]:
    """The widths of the last three stages' taps."""
    return [stage[-1][1] for stage in ARCH_DEFS[arch][-3:]]


class FBNetTrunk(nn.Module):
    def __init__(self, arch: str = "default", stem_channels: int = 16,
                 width_divisor: int = 1):
        super().__init__()
        if arch not in ARCH_DEFS:
            raise ValueError(f"unknown FBNet arch {arch!r}")
        self.stem = ConvNormRelu(3, stem_channels, 3, 2)
        in_ch = stem_channels
        stages = []
        for stage in ARCH_DEFS[arch]:
            blocks = []
            for op, C, stride, n in stage:
                for r in range(n):
                    s = stride if r == 0 else 1
                    if op == "skip":
                        blocks.append(Skip(in_ch, C, s))
                    else:
                        e, ker, se, cdw, sh, g = PRIMITIVES[op]
                        blocks.append(IRFBlock(in_ch, C, e, s, kernel=ker,
                                               se=se, cdw=cdw, shuffle_mid=sh,
                                               pw_group=g,
                                               width_divisor=width_divisor))
                    in_ch = C
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(images.permute(0, 3, 1, 2))
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs[-3:]
