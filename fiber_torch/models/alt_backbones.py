"""Alternative backbones: BERT and CLIP text towers, ResNet-50/101.

The PyTorch counterpart of `fiber_tpu/models/alt_backbones.py`:

* `BertTextEncoder`: the BERT encoder, the RoBERTa stack with 0-based
  positions and no pad offset (`embeddings.*`, `encoder.layer.{i}.*`);
* `ClipTextEncoder`: CLIP's text tower, a pre-LN causal transformer with
  learned positions, pooled at the EOT token (the largest id)
  (`token_embedding`, `positional_embedding`,
  `transformer.resblocks.{i}.*`, `ln_final`);
* `FrozenBatchNorm`: affine-only normalisation with baked statistics,
  held as buffers (`weight`, `bias`, `running_mean`, `running_var`);
* `ResNetBackbone`: ResNet-50 / 101 with frozen BatchNorm, giving the
  C2..C5 taps (`stem.{conv1,bn1}`, `layer{s}.{b}.{conv1..3,bn1..3,
  downsample.{0,1}}`, the reference's names).

The convs run NCHW; the trunk takes NHWC images and returns NCHW taps.
Where the JAX package pads "SAME" (the stem, the stride-2 3x3 convs, the
max pool), the padding is XLA's: the extra row and column go at the end.
The LayerNorms the JAX package builds with flax's default take eps 1e-6.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from fiber_torch.detection.dyhead import CLIPTransformerLayer
from fiber_torch.models.layers import Dropout
from fiber_torch.models.roberta import RobertaLayer, extended_attention_mask


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0
             ) -> torch.Tensor:
    """Pad an NCHW map as XLA's "SAME" does for a k x k window at stride s:
    the total max((ceil(n / s) - 1) s + k - n, 0), its larger half after."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class BertTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 max_position_embeddings: int = 512,
                 type_vocab_size: int = 2, drop: float = 0.1):
        super().__init__()
        self.embeddings = nn.Module()
        e = self.embeddings
        e.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        e.position_embeddings = nn.Embedding(max_position_embeddings,
                                             hidden_size)
        e.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        e.LayerNorm = nn.LayerNorm(hidden_size, eps=1e-6)
        e.dropout = Dropout(drop)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            RobertaLayer(hidden_size, num_heads, 4 * hidden_size,
                         attn_drop=drop, hidden_drop=drop)
            for _ in range(num_layers))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        e = self.embeddings
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (e.word_embeddings(input_ids) + e.position_embeddings(pos)[None]
             + e.token_type_embeddings(torch.zeros_like(input_ids)))
        x = e.dropout(e.LayerNorm(x))
        mask = extended_attention_mask(attention_mask, x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, attn_mask=mask)
        return x


class ClipTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, width: int = 512,
                 num_layers: int = 12, num_heads: int = 8,
                 context_length: int = 77):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            CLIPTransformerLayer(width, num_heads) for _ in range(num_layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-6)

    def forward(self, input_ids: torch.Tensor) -> dict:
        """input_ids (B, L) -> {"hidden": (B, L, width), "aggregate": the
        hidden state at each row's EOT (its largest id)}."""
        B, L = input_ids.shape
        x = self.token_embedding(input_ids)
        x = x + self.positional_embedding[:L].to(x.dtype)
        causal = torch.triu(torch.full((L, L), -1e9, device=x.device),
                            diagonal=1)
        for blk in self.transformer.resblocks:
            x = blk(x, attn_bias=causal)
        x = self.ln_final(x)
        eot = input_ids.argmax(dim=-1)
        return {"hidden": x,
                "aggregate": x[torch.arange(B, device=x.device), eot]}


class FrozenBatchNorm(nn.Module):
    """x * weight / sqrt(var + 1e-5) + bias - mean * weight / sqrt(var +
    1e-5), per channel of an NCHW map."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        mean, var = self.running_mean.float(), self.running_var.float()
        inv = w / torch.sqrt(var + 1e-5)
        shift = b - mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(
            x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = nn.Conv2d(features, 4 * features, 1, bias=False)
        self.bn3 = FrozenBatchNorm(4 * features)
        self.downsample = None
        if in_channels != 4 * features or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, 4 * features, 1, stride=stride,
                          bias=False),
                FrozenBatchNorm(4 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(same_pad(y, 3, self.stride))))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetBackbone(nn.Module):
    """ResNet trunk, `layers` (3, 4, 6, 3) for 50 and (3, 4, 23, 3) for
    101: NHWC images -> the NCHW taps [C2, C3, C4, C5]."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv1 = nn.Conv2d(3, 64, 7, stride=2, bias=False)
        self.stem.bn1 = FrozenBatchNorm(64)
        in_ch, feats = 64, 64
        self.num_stages = len(layers)
        for s, depth in enumerate(layers):
            blocks = []
            for b in range(depth):
                blocks.append(Bottleneck(in_ch, feats,
                                         2 if (b == 0 and s > 0) else 1))
                in_ch = 4 * feats
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            feats *= 2

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.stem.bn1(self.stem.conv1(same_pad(x, 7, 2))))
        x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)
        outs = []
        for s in range(self.num_stages):
            x = getattr(self, f"layer{s + 1}")(x)
            outs.append(x)
        return outs
