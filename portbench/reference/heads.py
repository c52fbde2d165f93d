"""Task heads, named as the reference checkpoint names them."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class Pooler(nn.Module):
    """First-token pooler: dense + tanh.  (B, L, D) -> (B, D)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(x[:, 0]))


class ITMHead(nn.Module):
    """Binary image-text-match head.  (B, 2D) -> (B, 2)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.fc = nn.Linear(in_features, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class MLMTransform(nn.Module):
    """dense -> erf GELU -> LayerNorm."""

    def __init__(self, hidden_size: int, layer_norm_eps: float):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(F.gelu(self.dense(x), approximate="none"))


class MLMHead(nn.Module):
    """BERT MLM head: transform + vocab decoder with a separate bias, as in
    the reference (`mlm_score.decoder.weight`, `mlm_score.bias`).
    (B, L, D) -> (B, L, V)."""

    def __init__(self, hidden_size: int, vocab_size: int,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.transform = MLMTransform(hidden_size, layer_norm_eps)
        self.decoder = nn.Linear(hidden_size, vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform(x)) + self.bias.to(x.dtype)


