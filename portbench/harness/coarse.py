"""The coarse-grained configurations' two sides: the program's
`FiberConfig` and the reference's model, built from one configuration
file, and the weights that both load."""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from portbench.harness import core

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(config: Mapping):
    """The port's `FiberConfig` of the configuration file."""
    from fiber_torch.config import FiberConfig
    fields = {f.name for f in dataclasses.fields(FiberConfig)}
    vals = {k: tuple(v) if isinstance(v, list) else v
            for k, v in {**config["model"], **config["optimizer"]}.items()
            if k in fields}
    num = config["numerics"]
    return FiberConfig(**vals, compute_dtype=DTYPES[num["compute_dtype"]],
                       param_dtype=DTYPES[num["param_dtype"]],
                       remat=num["remat"])


def reference_model(config: Mapping, device, remat: bool = False):
    """The reference's fp32 model, its weights still to load."""
    from portbench.reference.fiber import CoarseConfig, FiberCoarse
    return FiberCoarse(CoarseConfig.from_json(config["model"], remat=remat),
                       device)


def weight_shapes(config: Mapping) -> Dict[str, Tuple[int, ...]]:
    model = reference_model(config, "meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def weights_of(config: Mapping, shapes: Mapping, seed: int, device
               ) -> Dict[str, torch.Tensor]:
    """The run's fp32 weights of the parameters `shapes`, drawn on
    `device` from the seed by the configuration's rules."""
    return core.seeded_weights(shapes, core.derive(seed, "weights"), device,
                               config["weights"])


def weights(config: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's fp32 weights of the coarse model."""
    return weights_of(config, weight_shapes(config), seed, device)


@torch.no_grad()
def leaf_norms(names, tensors) -> Dict[str, float]:
    """{name: fp32 norm} of each tensor."""
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors]))
    return dict(zip(names, norms.tolist()))


class NegativesSpy:
    """While entered, records the negatives that the program's mining
    (`fiber_torch.objectives.coarse.mine_hard_negatives`) picks: a
    (text-to-image, image-to-text) pair of columns a step, as it returns
    them."""

    def __init__(self, objectives):
        self.objectives = objectives
        self.chosen: list = []
        self._step: list = []

    def __enter__(self) -> "NegativesSpy":
        self._mine = mine = self.objectives.mine_hard_negatives

        def recorded(*args, **kw):
            idx = mine(*args, **kw)
            self._step.append(idx)
            if len(self._step) == 2:
                self.chosen.append(tuple(self._step))
                self._step = []
            return idx

        self.objectives.mine_hard_negatives = recorded
        return self

    def __exit__(self, *exc) -> None:
        self.objectives.mine_hard_negatives = self._mine
