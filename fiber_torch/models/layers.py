"""Shared building blocks (MLP, stochastic depth, init helpers)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


def trunc_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None,
                  std: float = 0.02) -> torch.Tensor:
    """timm-style truncated normal (std 0.02, cut at two std), used by Swin."""
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None,
            std: float = 0.02) -> torch.Tensor:
    """BERT-style normal init (std 0.02), used by RoBERTa and the heads."""
    return nn.init.normal_(w, std=std, generator=generator)


def init_linear(m: nn.Linear, generator: Optional[torch.Generator],
                trunc: bool) -> None:
    """Weights as the JAX package draws them, bias zero."""
    (trunc_normal_ if trunc else normal_)(m.weight, generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> erf GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, drop_rate: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop = nn.Dropout(drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(self.fc1(x), approximate="none"))
        return self.drop(self.fc2(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath semantics); identity in
    eval mode.  `generator` draws the keep mask in training."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, device=x.device).bernoulli_(
            keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))
