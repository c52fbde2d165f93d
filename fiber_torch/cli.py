"""Training CLI of the coarse stack (the reference's `run.py with <task>
k=v`, Sacred-style, as plain argparse): data, `CoarseTrainer`,
`CheckpointManager` and resume in one loop.

Examples:
  python -m fiber_torch.cli --task pretrain_mlm_itm_itc --steps 100 \\
      --data synthetic --per-device-batch 8
  python -m fiber_torch.cli --task finetune_irtr_itc --data a.arrow,b.arrow \\
      --output-dir ckpt --ckpt-every 1000 --resume
  python -m fiber_torch.cli --tiny --device cpu --steps 3

The port's counterpart of `fiber_tpu/cli.py`.  It runs on the card unless
`--device cpu` (a missing card raises).  It is data parallel when a process
group is configured (`fiber_torch/parallel/multihost.py`): each process
sets `FIBER_COORDINATOR=host:port`, `FIBER_NUM_PROCESSES` and
`FIBER_PROCESS_ID`, or runs under `torchrun` with
`FIBER_COORDINATOR=auto`; the backend is NCCL on the card and gloo with
`--device cpu`.  The global batch is `--per-device-batch` x the processes:
with synthetic data every rank draws the global batch from the seed and
keeps its rows, so R ranks train on the data one process does; arrow data
is sharded by rank (`ShardedBatchIterator`).  Rank 0 prints and writes the
checkpoints; NaN dumps carry the rank in their names.  With arrow data the host only decodes and stages uint8 images, and the
crop, flip, RandAugment and normalize run on the device (`finish_batch`),
unless `--host-transforms`.  A resumed run restores the trainer's state,
skips the batches the restored steps consumed, and draws each step's
preprocessing from a generator seeded by the step, so that it takes the
same steps an uninterrupted run takes.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterator

import numpy as np
import torch

from fiber_torch.config import TASK_PRESETS, FiberConfig
from fiber_torch.data.device_transforms import device_train_preprocess
from fiber_torch.data.transforms import (IMAGENET_DEFAULT_MEAN,
                                         IMAGENET_DEFAULT_STD)
from fiber_torch.parallel.mesh import create_mesh, shard_batch
from fiber_torch.parallel.multihost import (is_distributed,
                                            maybe_initialize_distributed,
                                            print0, process_count,
                                            process_index)
from fiber_torch.train.checkpoint import CheckpointManager
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils.nan_debug import NanDumper


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = v
    return out


def synthetic_batches(cfg: FiberConfig, batch_size: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Random data matching the pretraining batch schema — for smoke runs
    and throughput measurement without a dataset."""
    rng = np.random.default_rng(seed)
    L = cfg.max_text_len
    while True:
        ids = rng.integers(5, cfg.vocab_size, (batch_size, L)).astype(
            np.int32)
        ids[:, 0] = 0
        masks = np.ones_like(ids)
        labels = np.full_like(ids, -100)
        sel = rng.random((batch_size, L)) < 0.15
        labels[sel] = ids[sel]
        mlm_ids = ids.copy()
        mlm_ids[sel] = 4
        yield {
            "image": rng.standard_normal(
                (batch_size, cfg.image_size, cfg.image_size, 3)
            ).astype(np.float32),
            "text_ids": ids, "text_masks": masks,
            "text_ids_mlm": mlm_ids, "text_labels_mlm": labels,
        }


def arrow_batches(cfg: FiberConfig, paths, batch_size: int,
                  tokenizer=None, seed: int = 0,
                  device_preprocess: bool = False,
                  staging_size: int = 0):
    """Batches from reference-format .arrow files.

    With device_preprocess=True the host only decodes to uint8 staging
    buffers ("image_staged" (B, S0, S0, 3) uint8 + "image_sizes" (B, 2));
    all geometric work (RandomResizedCrop/flip/RandAugment/normalize)
    runs on the device (`finish_batch`, data/device_transforms.py)."""
    from fiber_torch.data.arrow_dataset import (ArrowCaptionDataset,
                                                ShardedBatchIterator)
    from fiber_torch.data.mlm import mlm_mask
    from fiber_torch.data.tokenizer import (WhitespaceTokenizer,
                                            load_tokenizer)
    if tokenizer is None:
        try:
            tokenizer = load_tokenizer("roberta-base")
        except Exception:
            tokenizer = WhitespaceTokenizer()
    ds = ArrowCaptionDataset(paths)
    it = ShardedBatchIterator(len(ds), batch_size, host_id=process_index(),
                              num_hosts=process_count(), seed=seed)
    rng = np.random.default_rng(seed)
    staging = staging_size or (cfg.image_size * 3) // 2
    for idx in it:
        if device_preprocess:
            staged, sizes = zip(*(ds.stage_image(i, staging)
                                  for i in idx))
            img_fields = {"image_staged": np.stack(staged),
                          "image_sizes": np.stack(sizes)}
        else:
            images = np.stack([ds.get_image(i, cfg.image_size, train=True,
                                            rng=rng) for i in idx])
            images = ((images.astype(np.float32) / 255.0
                       - np.array(IMAGENET_DEFAULT_MEAN, np.float32))
                      / np.array(IMAGENET_DEFAULT_STD, np.float32))
            img_fields = {"image": images}
        caps = [ds.get_caption(i) for i in idx]
        if hasattr(tokenizer, "batch"):
            enc = tokenizer.batch(caps, max_length=cfg.max_text_len)
        else:
            enc = tokenizer(caps, max_length=cfg.max_text_len,
                            padding="max_length", truncation=True,
                            return_tensors="np")
        ids = np.asarray(enc["input_ids"], np.int32)
        masks = np.asarray(enc["attention_mask"], np.int32)
        special = (ids == getattr(tokenizer, "bos_token_id", 0)) | \
                  (ids == getattr(tokenizer, "eos_token_id", 2)) | \
                  (masks == 0)
        mlm_ids, labels = mlm_mask(
            ids, special, cfg.vocab_size,
            getattr(tokenizer, "mask_token_id", 4), rng)
        yield {**img_fields, "text_ids": ids, "text_masks": masks,
               "text_ids_mlm": mlm_ids.astype(np.int32),
               "text_labels_mlm": labels.astype(np.int32)}


def finish_batch(batch: Dict[str, torch.Tensor], cfg: FiberConfig,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The staged uint8 images ("image_staged", "image_sizes") of a batch
    on the device -> "image", through `device_train_preprocess` on the
    generator's device, in the config's compute dtype."""
    batch = dict(batch)
    staged = batch.pop("image_staged")
    sizes = batch.pop("image_sizes")
    batch["image"] = device_train_preprocess(staged, sizes, generator,
                                             cfg.image_size,
                                             dtype=cfg.compute_dtype)
    return batch


def preprocess_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of one step's device preprocessing: seeded by the run
    and the step, so that a resumed run draws what the uninterrupted one
    drew."""
    return torch.Generator(device=device).manual_seed(
        (seed + 1) * 1_000_003 + step)


def train(args) -> Dict[str, float]:
    overrides = _parse_overrides(args.set)
    cfg = TASK_PRESETS[args.task](**overrides)
    if args.steps:
        cfg = cfg.replace(max_steps=args.steps)
    if args.tiny:
        cfg = FiberConfig.tiny_test(loss_names=cfg.loss_names,
                                    max_steps=cfg.max_steps)

    rank, world = process_index(), process_count()
    trainer = CoarseTrainer(cfg, device=args.device, seed=args.seed,
                            ema_decay=args.ema,
                            mesh=create_mesh() if is_distributed() else None)
    ckpt = None
    if args.output_dir:
        ckpt = CheckpointManager(args.output_dir,
                                 best_metric_name="the_metric")
        if args.resume and ckpt.latest_step() is not None:
            # rank 0 saved from its card: each rank reads to its own (the
            # generator states stay on the host)
            trainer.load_state_dict(ckpt.restore(
                map_location={"cuda:0": str(trainer.device)}
                if trainer.device.type == "cuda" else None))
            print0(f"resumed from step {trainer.step}")
    start = trainer.step

    global_batch = args.per_device_batch * world
    device_pp = args.data != "synthetic" and not args.host_transforms
    if args.data == "synthetic":
        batches = (shard_batch(b, trainer.group) for b in
                   synthetic_batches(cfg, global_batch, args.seed))
    else:
        batches = arrow_batches(cfg, args.data.split(","),
                                args.per_device_batch, seed=args.seed,
                                device_preprocess=device_pp)
    for _ in range(start):             # the batches of the restored steps
        next(batches)

    metrics = {}
    t0 = time.time()
    nan_dumper = NanDumper(getattr(args, "nan_dump_dir", None)
                           or (args.output_dir and
                               os.path.join(args.output_dir, "nan_dumps")),
                           tag=f"rank{rank}" if world > 1 else None)
    saved = None
    for step in range(start, cfg.max_steps):
        batch = trainer.to_device(next(batches))
        if device_pp:
            batch = finish_batch(batch, cfg, preprocess_generator(
                trainer.device, args.seed, step))
        metrics = trainer.train_step(batch)
        loss = float(metrics["total_loss"])
        # train_step zeroes non-finite grads (ref trainer.py:162-164), so
        # post-step params differ from the offending forward only by the
        # decoupled weight-decay step — valid for replay.
        nan_dumper.check(step, loss, batch, trainer.model.state_dict(),
                         metrics)
        if step % args.log_every == 0 or step == cfg.max_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            print0(f"step {step} " +
                   " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())) +
                   f" ({global_batch * (step + 1 - start) / max(dt, 1e-6):.1f}"
                   f" ex/s)", flush=True)
        if ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, trainer.state_dict())
            saved = step + 1
    if ckpt and saved != trainer.step:
        ckpt.save(trainer.step, trainer.state_dict())
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--task", default="pretrain_mlm_itm_itc",
                   choices=sorted(TASK_PRESETS))
    p.add_argument("--set", nargs="*", metavar="KEY=VALUE",
                   help="FiberConfig overrides")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic' or comma-separated .arrow paths")
    p.add_argument("--per-device-batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", type=float, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke tests")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--host-transforms", action="store_true",
                   help="PIL geometric transforms on the host instead of "
                        "the on-device pipeline (arrow data only)")
    p.add_argument("--nan-dump-dir", default=None,
                   help="dump batch+params here on a non-finite loss "
                        "(default: <output-dir>/nan_dumps)")
    args = p.parse_args(argv)
    was_up = is_distributed()
    maybe_initialize_distributed(
        backend="gloo" if args.device == "cpu" else None)
    if is_distributed():
        print0(f"data parallel: {process_count()} processes "
               f"({torch.distributed.get_backend()})", flush=True)
    try:
        return train(args)
    finally:
        if is_distributed() and not was_up:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
