"""Detection / grounding training CLI, on one device or data parallel.

    python -m fiber_torch.tools.train_det --steps 100 --image-size 800x1344 \\
        --batch 2
    python -m fiber_torch.tools.train_det --tiny --device cpu --steps 3

The port's counterpart of `tools/train_det.py`: `DetectionTrainer` on
seeded synthetic batches (FIBER-B in bf16 over fp32 parameters unless
`--tiny`), the global-norm clip at 1, the EMA, a warmup of a tenth of the
steps (at most 2000).  It runs on the card unless `--device cpu` (a missing
card raises).  `--image-size` takes H or HxW.  The last line printed is
one JSON object: every step's losses, `finite` and the seconds taken.

Under a process group (`FIBER_COORDINATOR`, as for `fiber_torch.cli`;
gloo with `--device cpu`) `--batch` is each rank's: every rank draws the
global batch from the seed and keeps its rows, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from fiber_torch.detection.detector import DetectorConfig
from fiber_torch.parallel.mesh import create_mesh, shard_batch
from fiber_torch.parallel.multihost import (is_distributed,
                                            maybe_initialize_distributed,
                                            print0, process_count)
from fiber_torch.train.detection_trainer import DetectionTrainer
from fiber_torch.utils.nan_debug import NanDumper


def synthetic_batches(cfg: DetectorConfig, batch: int, max_boxes: int = 8,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Seeded random batches at `cfg.image_size`: 1 to max_boxes boxes an
    image, each grounded on one random token."""
    rng = np.random.default_rng(seed)
    H, W = cfg.image_size
    T = cfg.max_query_len
    while True:
        n = rng.integers(1, max_boxes + 1, batch)
        boxes = np.zeros((batch, max_boxes, 4), np.float32)
        valid = np.zeros((batch, max_boxes), bool)
        pm = np.zeros((batch, max_boxes, T), np.float32)
        for b in range(batch):
            for g in range(n[b]):
                x1, y1 = rng.uniform(0, W - 64), rng.uniform(0, H - 64)
                w, h = rng.uniform(32, 128), rng.uniform(32, 128)
                boxes[b, g] = [x1, y1, min(x1 + w, W - 1),
                               min(y1 + h, H - 1)]
                valid[b, g] = True
                pm[b, g, rng.integers(1, T - 1)] = 1.0
        ids = rng.integers(5, cfg.vocab_size, (batch, T)).astype(np.int32)
        yield {
            "images": rng.standard_normal((batch, H, W, 3)).astype(
                np.float32),
            "input_ids": ids,
            "attention_mask": np.ones_like(ids),
            "gt_boxes": boxes, "gt_valid": valid, "positive_map": pm,
        }


def parse_size(text: str) -> Tuple[int, int]:
    """"H" -> (H, H); "HxW" -> (H, W)."""
    parts = [int(v) for v in text.lower().split("x")]
    if len(parts) not in (1, 2):
        raise argparse.ArgumentTypeError(f"image size {text!r}: H or HxW")
    return (parts[0], parts[-1])


def main(argv: Optional[Sequence[str]] = None) -> DetectionTrainer:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--image-size", type=parse_size, default=(448, 448),
                   help="H or HxW, multiples of 32")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lang-lr", type=float, default=1e-5)
    p.add_argument("--ema", type=float, default=0.999)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--nan-dump-dir", default=None,
                   help="dump (batch, params) on a non-finite loss "
                        "(fiber_torch/utils/nan_debug.py)")
    args = p.parse_args(argv)
    maybe_initialize_distributed(
        backend="gloo" if args.device == "cpu" else None)

    if args.tiny:
        cfg = DetectorConfig.tiny_test()
    else:
        cfg = DetectorConfig(image_size=args.image_size,
                             compute_dtype=torch.bfloat16)
    trainer = DetectionTrainer(cfg, device=args.device, seed=args.seed,
                               base_lr=args.lr, lang_lr=args.lang_lr,
                               max_iter=args.steps, ema_decay=args.ema,
                               warmup_iters=min(2000, args.steps // 10),
                               clip_norm=1.0,
                               mesh=create_mesh() if is_distributed()
                               else None)
    batches = (shard_batch(b, trainer.group) for b in synthetic_batches(
        cfg, args.batch * process_count(), seed=args.seed))
    nan_dumper = NanDumper(args.nan_dump_dir)
    steps = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = next(batches)
        metrics = trainer.train_step(batch)
        # reading a metric waits for the device: only at the log steps, or
        # every step when NaN dumps are asked for
        if nan_dumper.enabled and float(metrics["finite"]) == 0.0:
            nan_dumper.check(step, float("nan"), batch,
                             trainer.model.state_dict(),
                             {k: float(v) for k, v in metrics.items()})
        steps.append(metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print0(f"step {step} " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(m.items())) +
                f" ({args.batch * (step + 1) / (time.perf_counter() - t0):.2f}"
                " img/s)", flush=True)
    seconds = time.perf_counter() - t0
    print0(json.dumps({
        "steps": [{k: float(v) for k, v in m.items()} for m in steps],
        "seconds": seconds, "image_size": list(cfg.image_size),
        "batch": args.batch}))
    return trainer


if __name__ == "__main__":
    main()
