"""Shared building blocks (dropout, MLP, stochastic depth, init helpers).

Every random draw of the model comes from an explicit `torch.Generator`
held by the module that draws (`Dropout`, `DropPath`, and the Swin blocks
that replay their draws under activation checkpointing); `set_generator`
hands one generator to all of them.  A module whose generator is None
draws from PyTorch's default generator.
"""

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


# the std of a unit normal cut at +-2, which flax's variance scaling divides
# out so that a truncated draw keeps the variance asked for
_TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None,
                  fan_in: Optional[int] = None) -> torch.Tensor:
    """flax's default kernel init: a normal cut at two of its std, scaled so
    that the drawn weights have std 1/sqrt(fan_in) (default w[0].numel(),
    a Linear's or Conv2d's fan-in)."""
    fan_in = w[0].numel() if fan_in is None else fan_in
    return trunc_normal_(w, generator, std=fan_in ** -0.5 / _TRUNC_NORMAL_STD)


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


def set_generator(module: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Hand `generator` to every submodule that draws random numbers (each
    has a `generator` attribute)."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 whatever autocast says: attention logits stay fp32
    under a bf16 autocast, as the JAX package keeps them."""
    with torch.autocast(a.device.type, enabled=False):
        return torch.matmul(a.float(), b.float())


class Dropout(nn.Module):
    """Element-wise dropout drawing its keep mask from `generator`;
    identity in eval mode or at rate 0."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> erf GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, drop_rate: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop = Dropout(drop_rate)

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
