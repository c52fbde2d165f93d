"""Plain building blocks of the reference: dropout, drop-path, MLP, the
window attention, and the float8 linears and convolutions of the
control.

A frozen copy of the port's plain path (`fiber_torch/models/layers.py`,
`fiber_torch/ops/window_attention.py::window_attention_reference`),
written against nothing of the port.  Every random draw comes from the
module's `generator`, in the port's order, so that a reference handed a
generator seeded as the program's draws the program's dropout masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


def set_generator(module: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Hand `generator` to every submodule that draws random numbers."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 whatever autocast says."""
    with torch.autocast(a.device.type, enabled=False):
        return torch.matmul(a.float(), b.float())


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Windowed multi-head attention on packed (B, nW, N, 3C) projections
    with an (nW, h, N, N) additive bias: q scaled before the product, fp32
    logits and softmax, the probabilities cast back to the input dtype,
    then P.V.  Returns (B, nW, N, C)."""
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    q, k, v = (t.reshape(B, nW, N, num_heads, hd).transpose(2, 3)
               for t in qkv.split(C, dim=-1))
    acc = torch.promote_types(q.dtype, torch.float32)
    with torch.autocast(q.device.type, enabled=False):
        attn = torch.matmul((q * hd ** -0.5).to(acc),
                            k.to(acc).transpose(-1, -2))
        attn = torch.softmax(attn + bias[None].to(acc), dim=-1).to(q.dtype)
        out = torch.matmul(attn, v)
    return out.transpose(2, 3).reshape(B, nW, N, C)


class Dropout(nn.Module):
    """Element-wise dropout drawing its keep mask from `generator`."""

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
    """fc1 -> erf GELU -> dropout -> fc2 -> dropout."""

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
    """Per-sample stochastic depth; its keep mask from `generator`."""

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


# ---------------------------------------------------------------------------
# The control: every linear's and convolution's operands in float8
# ---------------------------------------------------------------------------
def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """`x` rounded to `dtype` under one scale for the tensor (its max-abs
    to the type's largest value), and back in `x`'s dtype."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


def _rounded(x: torch.Tensor) -> torch.Tensor:
    """fp8 e4m3 forward value, straight-through gradient."""
    return x + (fp8_round(x) - x).detach()


class Fp8Linear(nn.Linear):
    """A linear whose input and weight are rounded to float8 e4m3 and
    whose output gradient is rounded to e5m2: the operands of an fp8 GEMM,
    as fp8 training keeps them."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_rounded(x), _rounded(self.weight), self.bias)
        return _RoundGrad.apply(y)


class Fp8Conv2d(nn.Conv2d):
    """A convolution on float8 e4m3 operands (its deformable use rounds
    them where it samples: `dyhead.Conv3x3Norm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(_rounded(x), _rounded(self.weight), self.bias)
        return _RoundGrad.apply(y)


def use_fp8(model: nn.Module) -> nn.Module:
    """Every `nn.Linear` and `nn.Conv2d` of `model` computed on float8
    operands (in place): the control, one precision below bf16."""
    for m in model.modules():
        if type(m) is nn.Linear:
            m.__class__ = Fp8Linear
        elif type(m) is nn.Conv2d:
            m.__class__ = Fp8Conv2d
    return model
