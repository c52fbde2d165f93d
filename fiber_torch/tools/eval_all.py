"""Evaluate every checkpoint in an output directory (reference:
tools/eval_all.py).

    python -m fiber_torch.tools.eval_all --dir OUT
        [--task pretrain_mlm_itm_itc] [--tiny] [--device cuda|cpu]

The PyTorch counterpart of the JAX repo's `tools/eval_all.py`: every step
that `fiber_torch.train.checkpoint.CheckpointManager` saved in `--dir`
(as `python -m fiber_torch.cli --output-dir` writes them) is restored into
one `CoarseTrainer` of the task's preset, which runs `eval_step` on one
synthetic batch of EVAL_BATCH (`cli.synthetic_batches` from seed 0) with a
generator seeded 0; one JSON line a checkpoint, {"step": n, <metric>:
value, ...}, oldest first.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from fiber_torch.cli import synthetic_batches
from fiber_torch.config import TASK_PRESETS, FiberConfig
from fiber_torch.train.checkpoint import CheckpointManager
from fiber_torch.train.trainer import CoarseTrainer

EVAL_BATCH = 8


def eval_all(directory: str, trainer: CoarseTrainer,
             eval_fn: Callable[[CoarseTrainer], Dict[str, float]]
             ) -> Iterator[Tuple[int, Dict[str, float]]]:
    """Restore each saved step into `trainer`; yields (step,
    eval_fn(trainer))."""
    mgr = CheckpointManager(directory)
    # saved from a card: onto this trainer's (generator states stay on the
    # host); on the CPU everything to the host
    where = ({"cuda:0": str(trainer.device)}
             if trainer.device.type == "cuda" else "cpu")
    for step in mgr.steps():
        trainer.load_state_dict(mgr.restore(step, map_location=where))
        yield step, eval_fn(trainer)


def eval_metrics(trainer: CoarseTrainer, batch: Dict,
                 seed: int) -> Dict[str, float]:
    """`trainer.eval_step` on `batch` with a generator seeded from `seed`
    (the ITM negatives' draws), as floats."""
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    return {k: float(v) for k, v in trainer.eval_step(batch, gen).items()}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", required=True)
    p.add_argument("--task", default="pretrain_mlm_itm_itc",
                   choices=sorted(TASK_PRESETS))
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = TASK_PRESETS[args.task]()
    if args.tiny:
        cfg = FiberConfig.tiny_test(loss_names=cfg.loss_names)
    trainer = CoarseTrainer(cfg, device=args.device)
    batch = next(synthetic_batches(cfg, EVAL_BATCH))
    rows = []
    for step, metrics in eval_all(args.dir, trainer,
                                  lambda t: eval_metrics(t, batch, 0)):
        rows.append({"step": step, **metrics})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
