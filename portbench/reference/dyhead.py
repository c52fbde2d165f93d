"""VLDyHead without early fusion: the tower of dynamic convs (DyReLU,
DyFuse, modulated deformable convs) and the grounding heads, in NCHW.  The
reference's frozen copy of the port's plain path
(`fiber_torch/detection/dyhead.py`, FIBER's own configuration: fusion in
the backbone, no training heads), the port's module names.

`VLDyHead.forward` returns `box_cls`, `bbox_reg` and `centerness` as
(B, H, W, A k) and `dot_product_logits` as (B, H W A, T).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from portbench.reference.deform_conv import modulated_deform_conv2d
from portbench.reference.layers import Fp8Conv2d, fp8_round, matmul_fp32


def h_sigmoid(x: torch.Tensor, h_max: float = 1.0) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) * h_max / 6.0


class DyReLU(nn.Module):
    """Dynamic ReLU-B: out = max(x a1 + b1, x a2 + b2), with (a, b)
    predicted from the global average of x (reduction 4, lambda_a 2.0)."""

    def __init__(self, channels: int, reduction: int = 4,
                 lambda_a: float = 2.0):
        super().__init__()
        self.channels, self.lambda_a = channels, lambda_a
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, 4 * channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, C, H, W)
        y = h_sigmoid(self.fc(x.mean(dim=(2, 3))))
        a1, b1, a2, b2 = y.split(self.channels, dim=-1)
        a1 = (a1 - 0.5) * self.lambda_a + 1.0
        a2 = (a2 - 0.5) * self.lambda_a
        b1, b2 = b1 - 0.5, b2 - 0.5
        a1, b1, a2, b2 = (t[:, :, None, None] for t in (a1, b1, a2, b2))
        return torch.maximum(x * a1 + b1, x * a2 + b2)


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` that also takes a group of one value, as the JAX
    package's does (a 1x1 P7 level with a channel per group): the op
    itself, without `F.group_norm`'s check that a group holds more than one
    value."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps)


class Conv3x3Norm(nn.Module):
    """A 3x3 conv (modulated-deformable when offsets are given) and a
    GroupNorm of 16 groups, eps 1e-5."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 deformable: bool = False, num_groups: int = 16):
        super().__init__()
        self.stride, self.deformable = stride, deformable
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=stride,
                              padding=1)
        self.bn = GroupNorm(min(num_groups, out_channels), out_channels,
                            eps=1e-5)

    def forward(self, x: torch.Tensor, offset: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.deformable and offset is not None:
            weight = self.conv.weight
            if isinstance(self.conv, Fp8Conv2d):      # the control
                x, weight = fp8_round(x), fp8_round(weight)
            x = modulated_deform_conv2d(x, offset, mask, weight,
                                        self.conv.bias, stride=self.stride)
        else:
            x = self.conv(x)
        return self.bn(x)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The reference's `F.upsample_bilinear` (align_corners=True)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def reinterpret(buf: Optional[torch.Tensor], hu: int, wu: int
                ) -> Optional[torch.Tensor]:
    """The level-l offset or mask buffer as the conv over level l + 1 reads
    it.  The reference hands the deformable kernel level l's buffer, and
    the kernel indexes it flat with level l + 1's output strides: the first
    C hu wu values of each image's NCHW buffer, not a spatial crop."""
    if buf is None:
        return None
    B, C = buf.shape[:2]
    return buf.reshape(B, -1)[:, :C * hu * wu].reshape(B, C, hu, wu)


class DyConv(nn.Module):
    """One dynamic-conv stage over all FPN levels: for level l, the conv of
    level l, the stride-2 conv of level l - 1 and the upsampled conv of
    level l + 1, weighted by a level attention (h_sigmoid of the pooled
    features through a 1x1 conv and a ReLU) and averaged, then DyReLU.
    One offset conv per level feeds all three convs of that level."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_dyrelu: bool = True, use_dyfuse: bool = True,
                 use_deform: bool = True):
        super().__init__()
        self.use_dyfuse, self.use_deform = use_dyfuse, use_deform
        self.DyConv = nn.ModuleList([
            Conv3x3Norm(in_channels, out_channels, 1, use_deform),   # up
            Conv3x3Norm(in_channels, out_channels, 1, use_deform),   # same
            Conv3x3Norm(in_channels, out_channels, 2, use_deform)])  # down
        if use_dyfuse:
            # the level attention's 1x1 conv, under the reference's name
            self.AttnConv = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                          nn.Conv2d(in_channels, 1, 1))
        self.relu = DyReLU(out_channels) if use_dyrelu else nn.ReLU()
        if use_deform:
            self.offset = nn.Conv2d(in_channels, 27, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = len(feats)
        offsets, masks = [None] * n, [None] * n
        if self.use_deform:
            for i, f in enumerate(feats):
                om = self.offset(f)                      # (B, 27, H, W)
                offsets[i] = om[:, :18]
                masks[i] = torch.sigmoid(om[:, 18:])
        conv_up, conv_same, conv_down = self.DyConv
        outs = []
        for l, feat in enumerate(feats):
            temp = [conv_same(feat, offsets[l], masks[l])]
            if l > 0:
                temp.append(conv_down(feats[l - 1], offsets[l], masks[l]))
            if l < n - 1:
                hu, wu = feats[l + 1].shape[-2:]
                up = conv_up(feats[l + 1], reinterpret(offsets[l], hu, wu),
                             reinterpret(masks[l], hu, wu))
                temp.append(resize_bilinear(up, *feat.shape[-2:]))
            stacked = torch.stack(temp)                  # (k, B, C, H, W)
            if self.use_dyfuse:
                attn = torch.stack([h_sigmoid(F.relu(self.AttnConv(t)))
                                    for t in temp])
                stacked = stacked * attn                 # attn (k, B, 1, 1, 1)
            outs.append(stacked.mean(dim=0))
        return [self.relu(o) for o in outs]


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class Scale(nn.Module):
    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor([init_value]))



class VLDyHead(nn.Module):
    """The tower of `num_convs` DyConvs and the prediction heads."""

    def __init__(self, num_convs: int = 6, in_channels: int = 256,
                 channels: int = 256, num_anchors: int = 1,
                 lang_dim: int = 768, log_scale_init: float = 0.0,
                 prior_prob: float = 0.01, use_dyrelu: bool = True,
                 use_dyfuse: bool = True, use_deform: bool = True):
        super().__init__()
        self.channels, self.num_anchors = channels, num_anchors
        first = in_channels == channels
        self.dyhead_tower = nn.ModuleList(
            DyConv(in_channels if i == 0 else channels, channels,
                   use_dyrelu=use_dyrelu and (i > 0 or first),
                   use_dyfuse=use_dyfuse and (i > 0 or first),
                   use_deform=use_deform and (i > 0 or first))
            for i in range(num_convs))
        self.bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)
        self.centerness = nn.Conv2d(channels, num_anchors, 1)
        self.dot_product_projection_text = nn.Linear(lang_dim,
                                                     num_anchors * channels)
        self.log_scale = nn.Parameter(torch.tensor([float(log_scale_init)]))
        self.bias_lang = nn.Parameter(torch.zeros(lang_dim))
        self.bias0 = nn.Parameter(torch.tensor([self.bias_value]))
        self.scales = nn.ModuleList(Scale(1.0) for _ in range(5))

    def forward(self, feats: Sequence[torch.Tensor],
                lang_embedding: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """feats: the five FPN levels, NCHW; lang_embedding (B, T, lang_dim),
        padded positions zeroed."""
        x = list(feats)
        for dyconv in self.dyhead_tower:
            x = dyconv(x)
        # the normalised text embedding, halved and projected; the token
        # bias emb . bias_lang + bias0, in fp32
        emb = lang_embedding.float()
        norm = torch.sqrt((emb * emb).sum(dim=-1, keepdim=True) + 1e-24)
        emb = emb / norm.clamp_min(1e-12)
        dtype = x[0].dtype
        proj = self.dot_product_projection_text((emb / 2.0).to(dtype))
        token_bias = emb @ self.bias_lang.float() + self.bias0.float()
        B, T = emb.shape[:2]
        A, C = self.num_anchors, self.channels
        pt = proj.reshape(B, T, A, C).permute(0, 2, 3, 1)   # (B, A, C, T)
        temperature = torch.exp(self.log_scale.float())
        out = {"box_cls": [], "bbox_reg": [], "centerness": [],
               "dot_product_logits": []}
        for l, f in enumerate(x):
            out["box_cls"].append(nhwc(self.cls_logits(f)))
            out["bbox_reg"].append(nhwc(self.bbox_pred(f)
                                        * self.scales[l].scale.to(dtype)))
            out["centerness"].append(nhwc(self.centerness(f)))
            H, W = f.shape[-2:]
            queries = f.flatten(2).transpose(1, 2)[:, None]  # (B, 1, HW, C)
            logit = matmul_fp32(queries, pt)                 # (B, A, HW, T)
            logit = logit / temperature
            logit = logit + token_bias[:, None, None, :]
            logit = logit.clamp(-50000.0, 50000.0)
            out["dot_product_logits"].append(
                logit.permute(0, 2, 1, 3).reshape(B, H * W * A, T))
        return out
