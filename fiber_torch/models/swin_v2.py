"""Swin-v2 detection trunk: overlapping conv embeddings and layer scale.

The PyTorch counterpart of `fiber_tpu/models/swin_v2.py`.  The "v2" of the
reference's detection code differs from v1 by an overlapping `ConvEmbed`
stem (7x7, stride 4, padding 2) and conv downsamples (3x3, stride 2,
padding 1) in place of patchify and PatchMerging, an optional per-block
layer scale (`gamma`, 1e-4) and a LayerNorm on each output stage.  The
window attention is the Swin stack's: every block's attention core goes
through `fiber_torch.ops.window_attention.window_attention`, so on a CUDA
tensor K1 runs its forward and K2 its backward (the JAX package's
`use_pallas` switch has no counterpart: the tensor's device picks).

Images come in NHWC (B, H, W, 3); the blocks run NHWC; the taps leave
NCHW, as the FPN reads them.  Module names: `patch_embed.{proj,norm}`,
`layers.{s}.blocks.{b}.*` (the Swin block's names, and `gamma`),
`layers.{s}.downsample.{proj,norm}`, `norm{i}` for the output norms.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fiber_torch.models.swin import SwinBlock


class ConvEmbed(nn.Module):
    """Overlapping conv patch embedding and an optional LayerNorm, NHWC in
    and out."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int = 7,
                 stride: int = 4, padding: int = 2, use_norm: bool = True):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=stride, padding=padding)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class SwinV2Block(SwinBlock):
    """A detection-flavor Swin block (padded to window multiples) with an
    optional layer scale on both residual branches; a map no larger than
    one window takes no shift."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: float = 0.0, layer_scale: bool = False,
                 remat: bool = False):
        if max(input_resolution) <= window_size:
            shift_size = 0        # one padded window: the shift is a no-op
        super().__init__(dim, input_resolution, num_heads, window_size,
                         shift_size, mlp_ratio=mlp_ratio, drop=drop,
                         drop_path=drop_path, pad_to_window=True,
                         remat=remat)
        self.gamma = (nn.Parameter(torch.full((dim,), 1e-4))
                      if layer_scale else None)

    def _scale(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.gamma is None else x * self.gamma.to(x.dtype)


class SwinV2Stage(nn.Module):
    """A stage's blocks and the conv downsample after it (None last)."""

    def __init__(self, blocks: Sequence[nn.Module],
                 downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


def drop_path_rates(depths: Sequence[int], rate: float) -> List[float]:
    """The stochastic-depth rate of every block, rising linearly to
    `rate`."""
    return [float(d) for d in np.linspace(0, rate, sum(depths))]


class SwinV2Backbone(nn.Module):
    """The 4-stage Swin-v2 trunk: NHWC images -> the NCHW taps of
    `out_indices` (strides 4 / 8 / 16 / 32), each after its LayerNorm when
    `out_norm`."""

    def __init__(self, image_size: Tuple[int, int], embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.2,
                 layer_scale: bool = False,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 out_norm: bool = True, remat: bool = False):
        super().__init__()
        H, W = image_size
        self.out_indices = tuple(out_indices)
        self.patch_embed = ConvEmbed(3, embed_dim, 7, 4, 2)
        dpr = drop_path_rates(depths, drop_path_rate)
        res = (H // 4, W // 4)
        stages = []
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            lo = sum(depths[:i])
            blocks = [SwinV2Block(dim, res, num_heads[i], window_size,
                                  0 if b % 2 == 0 else window_size // 2,
                                  mlp_ratio=mlp_ratio, drop=drop_rate,
                                  drop_path=dpr[lo + b],
                                  layer_scale=layer_scale, remat=remat)
                      for b in range(depth)]
            down = (ConvEmbed(dim, 2 * dim, 3, 2, 1)
                    if i < len(depths) - 1 else None)
            stages.append(SwinV2Stage(blocks, down))
            res = (-(-res[0] // 2), -(-res[1] // 2))
        self.layers = nn.ModuleList(stages)
        if out_norm:
            for i in self.out_indices:
                setattr(self, f"norm{i}",
                        nn.LayerNorm(embed_dim * 2 ** i, eps=1e-5))
        self.out_norm = out_norm

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(images)
        outs = []
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            if i in self.out_indices:
                out = getattr(self, f"norm{i}")(x) if self.out_norm else x
                outs.append(out.permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
