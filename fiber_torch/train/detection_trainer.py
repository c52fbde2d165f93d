"""Detection training, on one device or data parallel over processes: the
solver and the step of the grounding detector.

The PyTorch counterpart of `fiber_tpu/train/detection_trainer.py`:

* AdamW in four groups, {base, language backbone} x {decay, no decay},
  each with its peak learning rate on the warmup multistep schedule (a
  linear warmup from `warmup_factor` x lr, then x `gamma` at each
  fractional milestone); the JAX package's group rule applied to the flax
  path of each port parameter (`utils/convert.py::detection_flax_path`);
* the global-norm clip of optax (scale by max / |g| only when |g| > max),
  written with `torch._foreach_*` and no host sync, after the NaN guard;
* the NaN guard: a non-finite loss zeroes the step's gradients, and AdamW
  still takes its step (the moments decay and the decoupled weight decay
  applies), as optax's update of zero gradients does;
* an `lr_scale` for the plateau scheduler and an EMA copy of the
  parameters.

The parameters are fp32 masters (`GroundingDetector(for_training=True)`)
and the losses run under the model's bf16 autocast.  On the card every
Swin block's window attention runs K1 forward (again in each recompute
with `remat`) and K2 backward.  The trainer owns one device generator,
seeded, that the dropouts and the MLM masking draw from.  It updates its
model, optimizer and EMA in place; `train_steps` is a plain loop with the
contract of the JAX package's `train_steps_scan` (the stacked total
losses).

Data parallel (a process group is up, or a `mesh` is given), as
`fiber_torch/train/trainer.py` does it: each rank takes its rows of the
global batch, the losses divide by global counts (`num_pos`, the
centerness sum, the MLM tokens), the MLM masking is drawn for the global
batch from `batch_generator` (seeded `seed` on every rank) and dropout
from `generator` (`seed + rank`); after backward the gradients (views of
one flat buffer) and the losses are summed over the ranks, then the NaN
guard on the global total, the frozen zeroing and the clip of the global
norm.  The parameters and the EMA stay equal on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

from fiber_torch.detection.detector import (DetectorConfig, GroundingDetector,
                                            detection_loss)
from fiber_torch.models.fiber import resolve_device
from fiber_torch.models.layers import set_generator
from fiber_torch.parallel.data_parallel import (all_reduce_grads_,
                                                all_reduce_metrics,
                                                broadcast_, flat_grads,
                                                rank_world)
from fiber_torch.parallel.mesh import data_group
from fiber_torch.parallel.multihost import rank_device
from fiber_torch.utils.convert import detection_flax_path

Metrics = Dict[str, torch.Tensor]
DET_GROUPS = ("base_decay", "base_nodecay", "lang_decay", "lang_nodecay")


def warmup_multistep_schedule(base_lr: float, max_iter: int,
                              milestones: Sequence[float] = (0.67, 0.89),
                              gamma: float = 0.1, warmup_iters: int = 2000,
                              warmup_factor: float = 0.001
                              ) -> Callable[[int], float]:
    """The learning rate at update `step` (0 for the first): a linear warmup
    from warmup_factor x base_lr over `warmup_iters` (the first update at
    warmup_factor x base_lr even with no warmup), then x gamma at each
    milestone, a fraction of `max_iter` (<= 1) or a step count."""
    boundaries = [int(m * max_iter) if m <= 1 else int(m)
                  for m in milestones]

    def schedule(step: int) -> float:
        warm = min(step / max(warmup_iters, 1), 1.0)
        scale = warmup_factor * (1 - warm) + warm
        for b in boundaries:
            if step >= b:
                scale *= gamma
        return base_lr * scale

    return schedule


class WarmupReduceLROnPlateau:
    """The host's plateau scheduler: after each evaluation, the learning-
    rate scale decays by `gamma` once the metric has not improved for
    `patience` evaluations, at most `max_decays` times.  The scale goes into
    `train_step` as `lr_scale`."""

    def __init__(self, patience: int = 2, gamma: float = 0.1,
                 minimize: bool = False, max_decays: int = 4):
        self.patience, self.gamma = patience, gamma
        self.minimize, self.max_decays = minimize, max_decays
        self.best: Optional[float] = None
        self.bad = 0
        self.decays = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        better = (self.best is None
                  or (metric < self.best if self.minimize
                      else metric > self.best))
        if better:
            self.best, self.bad = metric, 0
        else:
            self.bad += 1
            if self.bad >= self.patience and self.decays < self.max_decays:
                self.scale *= self.gamma
                self.decays += 1
                self.bad = 0
        return self.scale

    @property
    def exhausted(self) -> bool:
        return self.decays >= self.max_decays


def det_param_group(name: str, use_deform: bool = True,
                    early_fuse: str = "none") -> str:
    """The optimizer group of the port detector's parameter `name`: the
    language backbone or the rest ("base"), and no decay for biases and the
    scale and bias of a norm whose flax name holds "norm" (the DyConvs'
    GroupNorms, `gn`, and the MLM head's `transform_ln` decay, as in the
    JAX package)."""
    path = detection_flax_path(name, use_deform, early_fuse)
    parts = path.split("/")
    leaf = parts[-1]
    in_norm = any("norm" in part.lower() for part in parts)
    no_decay = leaf == "bias" or (in_norm and leaf in ("scale", "bias"))
    grp = "lang" if "language_backbone" in path else "base"
    return f"{grp}_{'nodecay' if no_decay else 'decay'}"


def make_detection_optimizer(model: GroundingDetector, base_lr: float,
                             lang_lr: float, weight_decay: float
                             ) -> torch.optim.AdamW:
    """AdamW (optax's defaults: betas 0.9 / 0.999, eps 1e-8) over the model's
    parameters in the four groups, empty ones left out; each group carries
    its peak lr as `base_lr`."""
    members: Dict[str, List[torch.nn.Parameter]] = {g: [] for g in DET_GROUPS}
    for name, p in model.named_parameters():
        members[det_param_group(name, model.cfg.use_deform,
                                model.cfg.early_fuse)].append(p)
    groups = []
    for g, params in members.items():
        if params:
            groups.append(dict(
                params=params, name=g,
                base_lr=lang_lr if g.startswith("lang") else base_lr,
                weight_decay=0.0 if g.endswith("_nodecay") else weight_decay))
    return torch.optim.AdamW(groups, lr=base_lr, betas=(0.9, 0.999),
                             eps=1e-8)


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm` in place: every gradient x max / |g|
    when the global norm |g| exceeds max, untouched otherwise.  Returns
    |g|; nothing is read back to the host."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class DetectionTrainer:
    """Owns the detector, its optimizer and EMA copy, and steps them.  Runs
    on the card unless `device="cpu"` (under a process group a bare "cuda"
    is the rank's card); metrics come back as 0-dim device tensors, so a
    step does not wait for the device; under a process group they are the
    global batch's."""

    def __init__(self, cfg: DetectorConfig, device="cuda", seed: int = 0,
                 base_lr: float = 1e-5, lang_lr: float = 1e-5,
                 weight_decay: float = 1e-4, max_iter: int = 100000,
                 ema_decay: Optional[float] = 0.999,
                 clip_norm: Optional[float] = None,
                 warmup_iters: int = 2000, mesh=None):
        self.cfg = cfg
        self.group = data_group(mesh)
        self.rank, self.world = rank_world(self.group)
        self.device = resolve_device(rank_device(device))
        self.seed = seed
        self.base_lr, self.lang_lr = base_lr, lang_lr
        self.weight_decay, self.max_iter = weight_decay, max_iter
        self.ema_decay, self.clip_norm = ema_decay, clip_norm
        self.warmup_iters = warmup_iters
        self.init_state()

    def init_state(self) -> None:
        """Weights drawn from the seed and kept fp32 (rank 0's on every
        rank), a fresh optimizer, the EMA copy, every parameter trainable,
        step 0."""
        dev = self.device
        self.generator = torch.Generator(device=dev).manual_seed(
            self.seed + self.rank)
        self.batch_generator = (
            self.generator if self.world == 1
            else torch.Generator(device=dev).manual_seed(self.seed))
        self.model = GroundingDetector(self.cfg, device=dev, seed=self.seed,
                                       for_training=True)
        set_generator(self.model, self.generator)
        self.params = list(self.model.parameters())
        broadcast_(self.params, self.group)
        # every parameter keeps a gradient, zero where no loss reaches it, so
        # that AdamW still applies its decay there, as optax does; all of
        # them views of one buffer
        self.flat_grad = flat_grads(self.params)
        self.optimizer = make_detection_optimizer(
            self.model, self.base_lr, self.lang_lr, self.weight_decay)
        self.schedules = [warmup_multistep_schedule(
            g["base_lr"], self.max_iter, warmup_iters=self.warmup_iters)
            for g in self.optimizer.param_groups]
        self.frozen: List[torch.nn.Parameter] = []
        self.ema = ([p.detach().clone() for p in self.params]
                    if self.ema_decay else None)
        self.step = 0

    def lr_at(self, count: int) -> List[float]:
        """Each group's learning rate at update `count`."""
        return [s(count) for s in self.schedules]

    def _grads(self, batch: Mapping[str, Any],
               generator: Optional[torch.Generator]) -> Metrics:
        """Forward and backward into the parameters' grads, summed over the
        ranks; a non-finite global total loss zeroes them all, then the
        frozen ones are zeroed, then the clip.  No host sync."""
        self.flat_grad.zero_()
        losses = detection_loss(self.model, batch, train=True,
                                generator=(generator if generator is not None
                                           else self.batch_generator),
                                group=self.group)
        losses["total_loss"].backward()
        all_reduce_grads_(self.flat_grad, self.group)
        metrics = all_reduce_metrics(
            {k: v.detach() for k, v in losses.items()}, self.group)
        finite = torch.isfinite(metrics["total_loss"])
        self.flat_grad.masked_fill_(~finite, 0.0)
        if self.frozen:
            torch._foreach_zero_([p.grad for p in self.frozen])
        if self.clip_norm:
            clip_by_global_norm_([p.grad for p in self.params],
                                 self.clip_norm)
        metrics["finite"] = finite.float()
        return metrics

    def _update(self, lr_scale: float) -> None:
        """One AdamW update at this step's learning rates x lr_scale, then
        the EMA."""
        for g, lr in zip(self.optimizer.param_groups, self.lr_at(self.step)):
            g["lr"] = lr * lr_scale
        self.optimizer.step()
        self.step += 1
        if self.ema is not None:
            d = self.ema_decay
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, [p.detach() for p in self.params],
                                alpha=1.0 - d)

    def train_step(self, batch: Mapping[str, Any], lr_scale: float = 1.0,
                   generator: Optional[torch.Generator] = None) -> Metrics:
        """One step: losses, backward, NaN guard, frozen zeroing, clip,
        AdamW, EMA.  `generator` draws the MLM masking (default:
        `batch_generator`; seed it alike on every rank); the dropouts draw
        from `generator`.  The metrics are the losses and `finite` (1 when
        the total loss was finite)."""
        self.model.train()
        metrics = self._grads(batch, generator)
        self._update(lr_scale)
        return metrics

    def train_steps(self, batches: Sequence[Mapping[str, Any]]
                    ) -> torch.Tensor:
        """One `train_step` per batch; the total losses, stacked."""
        return torch.stack([self.train_step(b)["total_loss"]
                            for b in batches])


class MultiScaleDetectionTrainer(DetectionTrainer):
    """Multi-scale training over the loader's fixed bucket set on one
    parameter set and one optimizer state.  The port's detector takes any
    input size (the Swin blocks build their shift masks for the size they
    are given, cached by size), so every bucket runs through the one model:
    `trainer_for` gives this trainer for every bucket."""

    def trainer_for(self, image_size) -> "MultiScaleDetectionTrainer":
        return self
