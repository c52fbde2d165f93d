"""AdamW with FIBER's six parameter groups and its warmup schedules.

The PyTorch counterpart of `fiber_tpu/train/optim.py`.  Groups are
{decay, no decay} x {base, head (x lr_mult_head), cross-modal
(x lr_mult_cross_modal)}; AdamW with betas (0.9, 0.98) and eps 1e-8; the
learning rate warms up linearly and then decays polynomially (power
`decay_power`, 1 = linear) or along a cosine.

A parameter's group is the JAX rule applied to the flax path that the
port's key maps from (`fiber_torch.utils.convert.flax_path`), so every
parameter lands in the group the JAX package gives it.  The schedule is
optax's `join_schedules([linear warmup, decay], [warmup])` evaluated at the
count of updates made so far: during warmup the first update runs at lr 0,
as optax's does.  `set_lr` writes it into the optimizer before each step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from fiber_torch.config import FiberConfig
from fiber_torch.utils.convert import flax_path

HEAD_NAMES = ("vqa_classifier", "nlvr2_classifier", "mlm_score", "itm_score")
CROSS_MODAL_NAMES = ("cross_modal", "i2t", "t2i")
GROUPS = ("base_decay", "base_nodecay", "head_decay", "head_nodecay",
          "cross_decay", "cross_nodecay")


def param_group(name: str) -> str:
    """The optimizer group of the port parameter `name`."""
    path = flax_path(name)
    parts = path.split("/")
    is_head = any(h in path for h in HEAD_NAMES)
    is_cross = any(c in path for c in CROSS_MODAL_NAMES)
    leaf = parts[-1]
    in_norm = any("norm" in part.lower() for part in parts)
    no_decay = leaf == "bias" or (in_norm and leaf in ("scale", "bias"))
    if is_head and not is_cross:
        grp = "head"
    elif is_cross and not is_head:
        grp = "cross"
    else:
        grp = "base"
    return f"{grp}_{'nodecay' if no_decay else 'decay'}"


def warmup_steps(cfg: FiberConfig) -> int:
    """`warmup_steps` as int steps, or as a fraction (< 1) of max_steps."""
    warmup = cfg.warmup_steps
    if isinstance(warmup, float) and warmup < 1:
        warmup = int(cfg.max_steps * warmup)
    return int(warmup)


def lr_at(cfg: FiberConfig, base_lr: float, count: int) -> float:
    """The learning rate of a group with peak `base_lr` at update `count`
    (0 for the first update)."""
    warmup = warmup_steps(cfg)
    if count < warmup:                      # optax.linear_schedule(0, base_lr)
        return -base_lr * (1.0 - count / warmup) + base_lr
    decay_steps = max(cfg.max_steps - warmup, 1)
    t = min(max(count - warmup, 0), decay_steps)
    if cfg.decay_power == "cosine":
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    frac = 1.0 - t / decay_steps
    return (base_lr - cfg.end_lr) * frac ** float(cfg.decay_power) + cfg.end_lr


def make_optimizer(cfg: FiberConfig, model: nn.Module) -> torch.optim.AdamW:
    """AdamW over the model's parameters in the six groups (empty groups
    left out); each group carries its peak lr as `base_lr`."""
    members: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        members[param_group(name)].append(p)
    mult = {"base": 1.0, "head": cfg.lr_mult_head,
            "cross": cfg.lr_mult_cross_modal}
    groups = []
    for g, params in members.items():
        if not params:
            continue
        base_lr = cfg.learning_rate * mult[g.split("_")[0]]
        groups.append(dict(
            params=params, name=g, base_lr=base_lr,
            lr=lr_at(cfg, base_lr, 0),
            weight_decay=0.0 if g.endswith("_nodecay") else cfg.weight_decay))
    return torch.optim.AdamW(groups, betas=(cfg.adam_beta1, cfg.adam_beta2),
                             eps=cfg.adam_eps)


def set_lr(optimizer: torch.optim.Optimizer, cfg: FiberConfig,
           count: int) -> None:
    """Each group's learning rate for update `count`."""
    for group in optimizer.param_groups:
        group["lr"] = lr_at(cfg, group["base_lr"], count)


def summarize_groups(model: nn.Module) -> Dict[str, int]:
    """Parameter count per optimizer group."""
    counts: Dict[str, int] = {}
    for name, p in model.named_parameters():
        g = param_group(name)
        counts[g] = counts.get(g, 0) + p.numel()
    return counts
