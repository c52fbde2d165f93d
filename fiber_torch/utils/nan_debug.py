"""NaN forensics: dump the full training state when a loss goes non-finite
and replay it later under different precisions.

Behavioral spec: the reference saves {x, y, loss, states, captions,
positive_map} to `<time>_states.pth` on a non-finite loss
(engine/trainer.py:140-194) and ships a replay debugger that reruns the
saved batch in fp32 vs AMP to locate the diverging term
(tools/train_net.py:150-217 debug_nan).  Here the dump is one compressed
.npz holding the batch, the params and the metrics flattened by key path —
readable anywhere with numpy, no framework needed — and the replay helper
re-evaluates any loss function on the dump per compute dtype, reporting
which loss terms are finite in each.

The port's counterpart of `fiber_tpu/utils/nan_debug.py`.  Tensors are
stored as numpy (bf16 widened to fp32); the parameters are the model's
`state_dict`, under its names.  `trainer_loss_fn` gives `replay` the
port's losses on a fresh `CoarseTrainer` whose model holds the dumped
parameters, run in fp32 or under bf16 autocast.

The trainer's NaN guard (zero the step's gradients, keep training) stays;
the dump gives a long run a post-mortem artifact instead of a silent skip.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

BATCH_PREFIX = "batch/"
PARAMS_PREFIX = "params/"
METRICS_PREFIX = "metrics/"


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mappings of tensors or arrays -> {prefix + 'a/b/c': array}."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = _numpy(value)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of flatten_tree for string-keyed dicts."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def dump_training_state(dump_dir: str, step: int, batch, params,
                        metrics: Optional[Dict[str, Any]] = None) -> str:
    """Write `<dump_dir>/nan_step<step>_<time>.npz` and return its path."""
    os.makedirs(dump_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {"step": np.asarray(step)}
    arrays.update(flatten_tree(batch, BATCH_PREFIX))
    arrays.update(flatten_tree(params, PARAMS_PREFIX))
    if metrics is not None:
        arrays.update(flatten_tree(metrics, METRICS_PREFIX))
    stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
    path = os.path.join(dump_dir, f"nan_step{int(step)}_{stamp}.npz")
    np.savez_compressed(path, **arrays)
    return path


def load_training_state(path: str) -> Tuple[int, Dict, Dict, Dict]:
    """Returns (step, batch, params, metrics); params by state_dict name."""
    with np.load(path) as data:
        step = int(data["step"])
        batch = {k[len(BATCH_PREFIX):]: data[k] for k in data.files
                 if k.startswith(BATCH_PREFIX)}
        params = unflatten_tree(
            {k[len(PARAMS_PREFIX):]: data[k] for k in data.files
             if k.startswith(PARAMS_PREFIX)})
        metrics = {k[len(METRICS_PREFIX):]: data[k] for k in data.files
                   if k.startswith(METRICS_PREFIX)}
    return step, batch, params, metrics


class NanDumper:
    """Host-side guard for training loops: on the first non-finite loss,
    dump the offending (batch, params) and remember the path.

    The step itself is still skipped/zeroed by the trainer's guard;
    training continues.  `max_dumps` bounds disk usage on a
    persistently-unstable run."""

    def __init__(self, dump_dir: Optional[str], max_dumps: int = 3):
        self.dump_dir = dump_dir
        self.max_dumps = max_dumps
        self.paths = []

    @property
    def enabled(self) -> bool:
        return self.dump_dir is not None

    def check(self, step: int, loss_value: float, batch, params,
              metrics: Optional[Dict[str, Any]] = None) -> Optional[str]:
        if np.isfinite(loss_value) or self.dump_dir is None:
            return None
        if len(self.paths) >= self.max_dumps:
            return None
        path = dump_training_state(self.dump_dir, step, batch, params,
                                   metrics)
        self.paths.append(path)
        print(f"[nan_debug] non-finite loss {loss_value} at step {step}; "
              f"state dumped to {path}")
        return path


def replay(path: str,
           loss_fn: Callable[[Dict, Dict, torch.dtype], Dict[str, Any]],
           dtypes: Tuple[str, ...] = ("float32", "bfloat16"),
           ) -> Dict[str, Dict[str, Any]]:
    """Re-evaluate `loss_fn(params, batch, compute_dtype)` on a dump under
    each compute dtype (ref debug_nan's fp32-vs-AMP comparison) and report
    {dtype: {metric: (value, finite)}}."""
    _, batch, params, _ = load_training_state(path)
    report: Dict[str, Dict[str, Any]] = {}
    for dt in dtypes:
        out = loss_fn(params, batch, getattr(torch, dt))
        report[dt] = {k: (float(v), bool(np.isfinite(float(v))))
                      for k, v in out.items() if np.ndim(_numpy(v)) == 0}
    return report


def trainer_loss_fn(cfg, device="cuda", seed: int = 0) -> Callable:
    """A `replay` loss function: the losses of `CoarseTrainer.eval_step`
    on a fresh trainer built from `cfg` at the compute dtype asked for,
    its model holding the dumped parameters (fp32 masters; the forward in
    that dtype under autocast)."""
    from fiber_torch.train.trainer import CoarseTrainer

    def loss_fn(params, batch, compute_dtype: torch.dtype):
        trainer = CoarseTrainer(cfg.replace(compute_dtype=compute_dtype),
                                device=device, seed=seed)
        trainer.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in params.items()})
        return trainer.eval_step(batch)
    return loss_fn
