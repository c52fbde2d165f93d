"""Few-shot detection finetuning CLI, on one device or data parallel.

    python -m fiber_torch.tools.finetune_det --tuning language_prompt_v2 \\
        --shots 5 [--img-root DIR --ann-file FILE.json] [--tiny]

The port's counterpart of `tools/finetune_det.py`: the reference's tuning
modes (full, linear_prob, language_prompt_v1..v4; the prompt modes freeze
the backbone, FPN and head and train the language backbone and / or the
zero-initialised prompt `tunable_linear`), X-shot subsets and early
termination, on `MultiScaleDetectionTrainer` (FIBER-B at 448^2 in bf16
over fp32 parameters unless `--tiny`).  With `--ann-file` the batches come
from `CocoGroundingDataset` and `DetectionBatcher` with the port's
tokenizer (`--tokenizer`, a local directory; the whitespace tokenizer
without one); without it, from seeded synthetic batches.  It runs on the
card unless `--device cpu`.  The last line printed is one JSON object: the
final and best loss, every step's total loss, and how far the frozen
parameters moved against the weight decay's bound.  Under a process
group (`FIBER_COORDINATOR`, as for `fiber_torch.cli`) `--batch` is each
rank's: `DetectionBatcher` shards the images by rank, the synthetic
batches are the global batch's rows of the rank, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fiber_torch.detection.detector import DetectorConfig
from fiber_torch.parallel.mesh import create_mesh, shard_batch
from fiber_torch.parallel.multihost import (is_distributed,
                                            maybe_initialize_distributed,
                                            print0, process_count)
from fiber_torch.tools.train_det import synthetic_batches
from fiber_torch.train.detection_trainer import MultiScaleDetectionTrainer
from fiber_torch.train.finetune import (TUNING_MODES, EarlyStopper,
                                        apply_tuning_mode, x_shot_subset)

BATCH_KEYS = ("images", "input_ids", "attention_mask", "gt_boxes",
              "gt_valid", "positive_map")
# one fp32 rounding a step, the slack of the frozen parameters' bound
_ULP = 2.0 ** -23


def coco_batches(args, cfg: DetectorConfig):
    """Endless `DetectionBatcher` passes over the (X-shot) grounding data at
    the config's bucket."""
    from fiber_torch.data.coco_datasets import CocoGroundingDataset
    from fiber_torch.data.loader import DetectionBatcher
    from fiber_torch.data.tokenizer import WhitespaceTokenizer, get_tokenizer
    tok = (get_tokenizer(args.tokenizer) if args.tokenizer
           else WhitespaceTokenizer())
    ds = CocoGroundingDataset(args.img_root, args.ann_file, tok,
                              max_query_len=cfg.max_query_len)
    if args.shots:
        keep = x_shot_subset(
            [ds._record(i)["labels"].tolist() for i in range(len(ds))],
            args.shots, np.random.default_rng(args.seed))
        ds.images = [ds.images[i] for i in keep]
        print(f"x-shot({args.shots}): {len(ds)} images")
    H, W = cfg.image_size
    while True:
        yield from DetectionBatcher(ds, args.batch, min_sizes=(min(H, W),),
                                    max_size=max(H, W),
                                    min_items=args.batch * 4, seed=args.seed)


def main(argv: Optional[Sequence[str]] = None) -> MultiScaleDetectionTrainer:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tuning", default="full", choices=TUNING_MODES)
    p.add_argument("--shots", type=int, default=0,
                   help="X-shot subsetting (0 = use everything)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=8)
    p.add_argument("--img-root", default=None)
    p.add_argument("--ann-file", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenizer", default=None,
                   help="a local tokenizer (a directory with vocab.json and "
                        "merges.txt); the whitespace tokenizer without one")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    maybe_initialize_distributed(
        backend="gloo" if args.device == "cpu" else None)

    prompt = args.tuning in ("language_prompt_v2", "language_prompt_v4")
    cfg = (DetectorConfig.tiny_test(add_linear_layer=prompt) if args.tiny
           else DetectorConfig(image_size=(448, 448),
                               compute_dtype=torch.bfloat16,
                               add_linear_layer=prompt))
    trainer = MultiScaleDetectionTrainer(
        cfg, device=args.device, seed=args.seed, base_lr=args.lr,
        max_iter=args.steps, warmup_iters=max(1, args.steps // 10),
        ema_decay=None, mesh=create_mesh() if is_distributed() else None)
    apply_tuning_mode(trainer, args.tuning)
    frozen_ids = {id(p) for p in trainer.frozen}
    n_train = sum(p.numel() for p in trainer.params
                  if id(p) not in frozen_ids)
    print0(f"tuning={args.tuning}: {n_train} trainable parameters, "
           f"{len(trainer.params) - len(frozen_ids)} tensors", flush=True)
    before = [p.detach().clone() for p in trainer.frozen]

    batches = (coco_batches(args, cfg) if args.ann_file
               else (shard_batch(b, trainer.group) for b in synthetic_batches(
                   cfg, args.batch * process_count(), seed=args.seed)))
    stopper = EarlyStopper(patience=args.patience, minimize=True)
    losses, decay_sum = [], {}
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: v for k, v in next(batches).items() if k in BATCH_KEYS}
        for g, lr in zip(trainer.optimizer.param_groups,
                         trainer.lr_at(trainer.step)):
            decay_sum[g["name"]] = (decay_sum.get(g["name"], 0.0)
                                    + lr * g["weight_decay"])
        metrics = trainer.train_step(batch)
        loss = float(metrics["total_loss"])
        losses.append(loss)
        if step % 10 == 0 or step == args.steps - 1:
            print0(f"step {step} loss={loss:.4f} "
                   f"({(step + 1) / (time.perf_counter() - t0):.2f} it/s)",
                   flush=True)
        if stopper.update(loss):
            print0(f"early stop at step {step} (best={stopper.best:.4f})")
            break
    # a frozen parameter moves only by the decoupled decay, prod(1 - lr wd)
    # <= sum(lr wd) of its value, and one rounding a step
    group_of = {id(p): g["name"] for g in trainer.optimizer.param_groups
                for p in g["params"]}
    excess, moved = 0.0, 0.0
    with torch.no_grad():
        for p, p0 in zip(trainer.frozen, before):
            d = (p - p0).abs()
            bound = (decay_sum[group_of[id(p)]] + len(losses) * _ULP) * p0.abs()
            excess = max(excess, float((d - bound).max()))
            moved = max(moved, float(d.max()))
    print0(json.dumps({"final_loss": losses[-1], "best": stopper.best,
                       "losses": losses, "tuning": args.tuning,
                       "trainable_params": n_train,
                       "frozen_tensors": len(frozen_ids),
                       "frozen_max_abs_move": moved,
                       "frozen_excess_over_decay": excess,
                       "seconds": time.perf_counter() - t0}))
    return trainer


if __name__ == "__main__":
    main()
