"""Backbone zoo: the BiFPN neck and the EfficientNet trunks, in NCHW.

The PyTorch counterpart of `fiber_tpu/models/backbone_zoo.py`, which
redesigned the reference's (EfficientDet's BiFPN with fast-normalised
fusion, depthwise-separable convs and swish; MBConv stages with SE, width
and depth scaled per variant) with GroupNorm in place of BatchNorm and
static nearest resizes.  The GroupNorms take flax's eps, 1e-6; a nearest
resize is jax.image.resize's (half-pixel centres, `nearest-exact`).
Module names are the JAX package's: `layers.{r}.{conv6_up,...,
p5_to_p6, p3_down_channel}` and the fusion weights `p6_w1`, ... of the
BiFPN; `stem`, `gn_stem`, `stages.{s}.{b}.*` of EfficientNet.  The trunk
takes NHWC images and returns NCHW taps.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.detection.dyhead import GroupNorm


def group_norm(channels: int) -> nn.GroupNorm:
    """GroupNorm of gcd(32, channels) groups, flax's eps (a group may hold
    one value, as in the JAX package)."""
    return GroupNorm(math.gcd(32, channels), channels, eps=1e-6)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def max_pool_down(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, padding 1 (-inf)."""
    return F.max_pool2d(x, 3, 2, padding=1)


class SeparableConv(nn.Module):
    """Depthwise 3x3, pointwise 1x1 and a GroupNorm."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.depthwise = nn.Conv2d(in_channels, in_channels, 3, padding=1,
                                   groups=in_channels, bias=False)
        self.pointwise = nn.Conv2d(in_channels, channels, 1)
        self.norm = group_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.pointwise(self.depthwise(x)))


# each fusion node: its weight name and the number of inputs
_FUSE_NODES = (("p6_w1", 2), ("p5_w1", 2), ("p4_w1", 2), ("p3_w1", 2),
               ("p4_w2", 3), ("p5_w2", 3), ("p6_w2", 3), ("p7_w2", 2))


class BiFPNLayer(nn.Module):
    """One BiFPN unit over five levels: a top-down and a bottom-up pass,
    each node a fast-normalised weighted sum (relu(w) / (sum + eps)), swish
    and a separable conv.  The first unit makes P3..P7 from the trunk's
    three taps (1x1 convs, a stride-2 conv and a max pool)."""

    def __init__(self, channels: int, first_time: bool = False,
                 in_channels: Sequence[int] = (512, 1024, 2048),
                 eps: float = 1e-4):
        super().__init__()
        self.first_time, self.eps = first_time, eps
        if first_time:
            c3, c4, c5 = in_channels[-3:]
            self.p5_to_p6 = nn.Conv2d(c5, channels, 3, stride=2, padding=1)
            self.p3_down_channel = nn.Conv2d(c3, channels, 1)
            self.p4_down_channel = nn.Conv2d(c4, channels, 1)
            self.p5_down_channel = nn.Conv2d(c5, channels, 1)
        for name in ("conv6_up", "conv5_up", "conv4_up", "conv3_up",
                     "conv4_down", "conv5_down", "conv6_down", "conv7_down"):
            setattr(self, name, SeparableConv(channels, channels))
        for name, n in _FUSE_NODES:
            setattr(self, name, nn.Parameter(torch.ones(n)))

    def _fuse(self, name: str, feats: List[torch.Tensor]) -> torch.Tensor:
        w = F.relu(getattr(self, name).float())
        w = w / (w.sum() + self.eps)
        out = sum(w[i].to(f.dtype) * f for i, f in enumerate(feats))
        return F.silu(out)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.first_time:
            c3, c4, c5 = inputs[-3:]
            p6 = self.p5_to_p6(c5)
            levels = [self.p3_down_channel(c3), self.p4_down_channel(c4),
                      self.p5_down_channel(c5), p6, max_pool_down(p6)]
        else:
            levels = list(inputs)
        p3, p4, p5, p6, p7 = levels
        up = lambda hi, ref: resize_nearest(hi, *ref.shape[-2:])
        p6_td = self.conv6_up(self._fuse("p6_w1", [p6, up(p7, p6)]))
        p5_td = self.conv5_up(self._fuse("p5_w1", [p5, up(p6_td, p5)]))
        p4_td = self.conv4_up(self._fuse("p4_w1", [p4, up(p5_td, p4)]))
        p3_out = self.conv3_up(self._fuse("p3_w1", [p3, up(p4_td, p3)]))
        p4_out = self.conv4_down(self._fuse(
            "p4_w2", [p4, p4_td, max_pool_down(p3_out)]))
        p5_out = self.conv5_down(self._fuse(
            "p5_w2", [p5, p5_td, max_pool_down(p4_out)]))
        p6_out = self.conv6_down(self._fuse(
            "p6_w2", [p6, p6_td, max_pool_down(p5_out)]))
        p7_out = self.conv7_down(self._fuse("p7_w2",
                                            [p7, max_pool_down(p6_out)]))
        return [p3_out, p4_out, p5_out, p6_out, p7_out]


class BiFPN(nn.Module):
    """`repeats` stacked BiFPN units; the first reads the trunk's taps."""

    def __init__(self, channels: int = 256, repeats: int = 3,
                 in_channels: Sequence[int] = (512, 1024, 2048)):
        super().__init__()
        self.layers = nn.ModuleList(
            BiFPNLayer(channels, first_time=r == 0, in_channels=in_channels)
            for r in range(repeats))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        x = list(feats)
        for layer in self.layers:
            x = layer(x)
        return x


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite: 1x1 expand (when
    expansion > 1), depthwise k x k, SE on the expanded features, 1x1
    project, a residual when the shape holds."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, expansion: int = 6,
                 se_ratio: float = 0.25):
        super().__init__()
        mid = in_channels * expansion
        self.residual = stride == 1 and in_channels == out_channels
        if expansion != 1:
            self.expand = nn.Conv2d(in_channels, mid, 1, bias=False)
            self.gn_expand = group_norm(mid)
        else:
            self.expand = None
        self.depthwise = nn.Conv2d(mid, mid, kernel_size, stride=stride,
                                   padding=kernel_size // 2, groups=mid,
                                   bias=False)
        self.gn_dw = group_norm(mid)
        se_ch = max(1, int(in_channels * se_ratio))
        self.se_reduce = nn.Linear(mid, se_ch)
        self.se_expand = nn.Linear(se_ch, mid)
        self.project = nn.Conv2d(mid, out_channels, 1, bias=False)
        self.gn_project = group_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = F.silu(self.gn_expand(self.expand(y)))
        y = F.silu(self.gn_dw(self.depthwise(y)))
        s = F.silu(self.se_reduce(y.mean(dim=(2, 3))))
        y = y * torch.sigmoid(self.se_expand(s))[:, :, None, None]
        y = self.gn_project(self.project(y))
        return y + x if self.residual else y


# (width_mult, depth_mult) of each variant
EFFICIENTNET_PARAMS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
    "b3": (1.2, 1.4), "b4": (1.4, 1.8), "b5": (1.6, 2.2),
    "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}
# (out_channels, kernel, stride, expansion, repeats) of each stage
BASE_STAGES = (
    (16, 3, 1, 1, 1), (24, 3, 2, 6, 2), (40, 5, 2, 6, 2),
    (80, 3, 2, 6, 3), (112, 5, 1, 6, 3), (192, 5, 2, 6, 4),
    (320, 3, 1, 6, 1),
)
# the stages that end at strides 8 / 16 / 32
TAP_STAGES = (2, 4, 6)


def scale_width(c: int, mult: float, divisor: int = 8) -> int:
    c = c * mult
    new = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new < 0.9 * c:
        new += divisor
    return new


def tap_channels(variant: str) -> List[int]:
    """The widths of the stride 8 / 16 / 32 taps of `variant`."""
    wm = EFFICIENTNET_PARAMS[variant][0]
    return [scale_width(BASE_STAGES[i][0], wm) for i in TAP_STAGES]


class EfficientNetBackbone(nn.Module):
    """EfficientNet trunk: NHWC images -> the NCHW taps at strides 8, 16
    and 32."""

    def __init__(self, variant: str = "b0"):
        super().__init__()
        wm, dm = EFFICIENTNET_PARAMS[variant]
        c_stem = scale_width(32, wm)
        self.stem = nn.Conv2d(3, c_stem, 3, stride=2, padding=1, bias=False)
        self.gn_stem = group_norm(c_stem)
        in_ch = c_stem
        stages = []
        for c, k, s, e, r in BASE_STAGES:
            c = scale_width(c, wm)
            blocks = []
            for b in range(int(math.ceil(r * dm))):
                blocks.append(MBConv(in_ch, c, k, s if b == 0 else 1, e))
                in_ch = c
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = F.silu(self.gn_stem(self.stem(images.permute(0, 3, 1, 2))))
        outs = []
        for si, stage in enumerate(self.stages):
            x = stage(x)
            if si in TAP_STAGES:
                outs.append(x)
        return outs
