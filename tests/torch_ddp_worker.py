"""One rank of the two-process CPU tests of the port's data parallelism.

    python tests/torch_ddp_worker.py <scenario> <rank> <world> <dir>

It imports only `fiber_torch` (never JAX), joins a gloo process group
through `maybe_initialize_distributed` (a `file://` store in `dir`, or the
`FIBER_*` environment when `FIBER_COORDINATOR` is set), reads the inputs
the test wrote to `dir/in.pt`, runs the scenario on this rank's rows of the
global batch, and writes what the test compares to `dir/out_rank<r>.pt`.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from fiber_torch.parallel import multihost  # noqa: E402
from fiber_torch.parallel.mesh import create_mesh, shard_batch  # noqa: E402


def _local(batch, world, rank):
    per = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def multihost_helpers(inp, rank, world):
    """The host-side gathers and the barrier."""
    objs = multihost.gather_objects({"rank": rank,
                                     "payload": "x" * (10 + 40 * rank)})
    merged = multihost.merge_eval_predictions({10 + rank: f"pred{rank}"})
    gathered = multihost.process_allgather(np.arange(6).reshape(2, 3) + rank)
    multihost.sync_global_devices("test")
    mesh = create_mesh()
    return {"objs": objs, "merged": merged, "gathered": gathered,
            "slice": multihost.local_batch_slice(8),
            "index": multihost.process_index(),
            "count": multihost.process_count(),
            "mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names)),
            "shard": shard_batch({"x": np.arange(8), "s": np.float32(3)},
                                 mesh.get_group("data"))}


def _fixed_mining(negatives):
    """The mining replaced by the global `negatives` (images, then texts);
    returns the list each call appends its `total_rows` to."""
    from fiber_torch.objectives import coarse as obj
    calls = []

    def mine(sim, valid, generator, row0=0, total_rows=None):
        idx = torch.as_tensor(negatives[len(calls) % 2])
        calls.append(total_rows)
        return idx[row0:row0 + sim.shape[0]]

    obj.mine_hard_negatives = mine
    return calls


def coarse_step(inp, rank, world):
    """One `CoarseTrainer.train_step` of MLM + ITC + hard-negative ITM on
    this rank's rows, its mining handed the global negatives."""
    from fiber_torch.config import FiberConfig
    from fiber_torch.train.trainer import CoarseTrainer
    tr = CoarseTrainer(FiberConfig.tiny_test(**inp["cfg"]), device="cpu",
                       seed=0, mesh=create_mesh())
    tr.model.load_state_dict(inp["model"])
    tr.queue.load_state_dict(inp["queue"])
    calls = _fixed_mining(inp["negatives"])
    batch = _local(inp["batch"], world, rank)
    with torch.no_grad():                     # this rank's partial MLM loss
        _, parts = tr.loss(batch, train=False)
    metrics = tr.train_step(batch)
    return {"metrics": metrics, "grads": _grads(tr.model),
            "params": _params(tr.model), "queue": tr.queue.state_dict(),
            "mlm_partial": parts["mlm_loss"],
            "mlm_count": int((batch["text_labels_mlm"] != -100).sum()),
            "mine_rows": calls, "grad_is_view": all(
                p.grad._base is tr.flat_grad for p in tr.params)}


def coarse_tasks(inp, rank, world):
    """One `train_step` each of the VQA and the caption-MLE trainers."""
    from fiber_torch.config import FiberConfig
    from fiber_torch.train.trainer import CoarseTrainer
    out = {}
    for name, (kw, batch) in inp["tasks"].items():
        tr = CoarseTrainer(FiberConfig.tiny_test(**kw), device="cpu", seed=0)
        metrics = tr.train_step(_local(batch, world, rank))
        out[name] = {"metrics": metrics, "params": _params(tr.model)}
    return out


def coarse_resume(inp, rank, world):
    """Two steps with dropout on, the state saved after the first and
    restored into a fresh trainer, whose second step must equal."""
    from fiber_torch.config import FiberConfig
    from fiber_torch.train.trainer import CoarseTrainer
    cfg = FiberConfig.tiny_test(**inp["cfg"])
    batches = [_local(b, world, rank) for b in inp["batches"]]
    a = CoarseTrainer(cfg, device="cpu", seed=0)
    a.train_step(batches[0])
    state = a.state_dict()
    b = CoarseTrainer(cfg, device="cpu", seed=5)
    b.load_state_dict(state)
    return {"a": a.train_step(batches[1]), "b": b.train_step(batches[1]),
            "pa": _params(a.model), "pb": _params(b.model),
            "dropout_states": len(state["dropout_generators"])}


def detection_step(inp, rank, world):
    """One `DetectionTrainer.train_step` with every optional head on this
    rank's rows, the MLM masking handed the global draws."""
    from fiber_torch.detection import mlm as tmlm
    from fiber_torch.detection.atss import batched_atss_assign
    from fiber_torch.detection.detector import (DetectorConfig,
                                                detector_anchors)
    from fiber_torch.models.layers import Dropout
    from fiber_torch.train.detection_trainer import DetectionTrainer
    cfg = DetectorConfig.tiny_test(**inp["heads"])
    tr = DetectionTrainer(cfg, device="cpu", mesh=create_mesh(),
                          **inp["trainer"])
    tr.model.load_state_dict(inp["model"], strict=True)
    for e, q in zip(tr.ema, tr.params):
        e.copy_(q.detach())
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    probs, rand = (torch.as_tensor(x) for x in inp["mlm_draws"])
    per = probs.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    orig = tmlm.random_word_mask

    def injected(gen, ids, *a, probs=None, rand_tokens=None, **kw):
        return orig(gen, ids, *a, probs=probs_l, rand_tokens=rand_l, **kw)

    probs_l, rand_l = probs[rows], rand[rows].long()
    tmlm.random_word_mask = injected
    batch = _local(inp["batch"], world, rank)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    anchors, sizes, _ = detector_anchors(cfg, tuple(b["images"].shape[1:3]))
    pos = batched_atss_assign(anchors, sizes, b["gt_boxes"].float(),
                              b["gt_valid"].bool(),
                              topk=cfg.atss_topk).pos_mask
    _, labels = orig(None, b["input_ids"].long(), cfg.mask_token_id,
                     cfg.vocab_size, cfg.pad_token_id,
                     b["greenlight_map"], probs=probs_l, rand_tokens=rand_l)
    metrics = tr.train_step(batch)
    return {"metrics": metrics, "grads": _grads(tr.model),
            "params": _params(tr.model), "ema": [e.clone() for e in tr.ema],
            "num_pos": int(pos.sum()),
            "mlm_tokens": int((labels != -100).sum()),
            "boxes": int(b["gt_valid"].sum())}


def _tp_trainer(inp, mesh):
    """A `CoarseTrainer` on `mesh` at `inp`'s config, holding `inp`'s one-
    process model and queue (the EMA restarted from them)."""
    from fiber_torch.config import FiberConfig
    from fiber_torch.parallel.tp import load_sharded_state_dict
    from fiber_torch.train.trainer import CoarseTrainer
    tr = CoarseTrainer(FiberConfig.tiny_test(**inp["cfg"]), device="cpu",
                       seed=0, mesh=mesh, ema_decay=0.9)
    load_sharded_state_dict(tr.model, inp["model"])
    tr.queue.load_state_dict(inp["queue"])
    for e, p in zip(tr.ema, tr.params):
        e.copy_(p.detach())
    return tr


def tp_step(inp, rank, world):
    """One `train_step` on a (data, model) mesh of `inp["data"]` data
    ranks, each data rank on its rows of the global batch with the global
    negatives: the metrics, every gradient and the state after it in one
    process's format, this rank's own shards.  On a (1, M) mesh model
    rank 1's patch-embed gradient is moved by a rounding first, and also: a
    one-process state (`inp["resume"]`) restored, its stacked stage-4
    blocks and its step on `inp["next"]`, and the errors of a mesh of the
    wrong size and of a rule that shards a convolution."""
    from fiber_torch.ops.swin_stage import stack_block_params
    from fiber_torch.parallel import tp
    n_data = inp["data"]
    mesh = create_mesh(data=n_data, model=world // n_data)
    tr = _tp_trainer(inp, mesh)
    _fixed_mining(inp["negatives"])
    data_rank = rank // (world // n_data)
    if n_data == 1 and rank == 1:
        # a whole parameter's gradient off by a rounding on one model rank,
        # as cuDNN's weight gradient of the patch-embed conv is on the card
        conv = tr.model.vit_model.patch_embed.proj.weight
        conv.register_hook(lambda g: g * (1 + 2 ** -20))
    tp.reset_collectives()
    metrics = tr.train_step(_local(inp["batch"], n_data, data_rank))
    out = {"metrics": metrics, "plan": tr.tp_plan, "local": _params(tr.model),
           "grads": {n: tr._whole(p, p.grad).clone()
                     for n, p in tr.model.named_parameters()},
           "state": tr.state_dict(), "collectives": dict(tp.COLLECTIVES),
           "grad_is_view": all(p.grad._base is tr.flat_grad
                               for p in tr.params),
           "flat_numel": tr.flat_grad.numel(),
           "local_numel": tp.local_numel(tr.model, tr.tp_plan,
                                         world // n_data)}
    if n_data > 1:
        return out
    again = _tp_trainer(inp, mesh)
    again.load_state_dict(inp["resume"])
    out["restored"] = copy.deepcopy(again.state_dict())
    blocks = again.model.vit_model.layers[3].blocks
    out["stack"] = stack_block_params(blocks, blocks[0].window,
                                      blocks[0].attn.num_heads,
                                      use_shift=blocks[1].shift > 0)
    out["next"] = again.train_step(inp["next"])
    errors = {}
    try:
        create_mesh(data=world, model=world)
    except ValueError as e:
        errors["mesh"] = str(e)
    conv = torch.nn.Module()
    conv.conv = torch.nn.Conv2d(64, 128, 3)
    try:
        tp.shard_params_tp(conv, mesh)
    except ValueError as e:
        errors["conv"] = str(e)
    out["errors"] = errors
    return out


def sharded_queue(inp, rank, world):
    """`inp["batches"]` stepped twice on two data ranks: with the queue's
    input rings split over the ranks (Q % R == 0) and with a whole-ring
    queue of the same start; each step's negatives and metrics, each
    queue's state and this rank's block.  Also: one process's queue state
    restored into a sharded queue, and a queue whose slots do not divide
    by the ranks."""
    from fiber_torch.config import FiberConfig
    from fiber_torch.objectives import coarse as obj
    from fiber_torch.parallel.itc_queue import INPUT_RINGS, ItcQueue
    from fiber_torch.train.trainer import CoarseTrainer
    cfg = FiberConfig.tiny_test(**inp["cfg"])
    mesh = create_mesh()
    group = mesh.get_group("data")

    def queue(size, group):
        return ItcQueue(size, cfg.hidden_size, cfg.image_size,
                        cfg.max_text_len, input_dtype=cfg.compute_dtype,
                        device="cpu", group=group,
                        generator=torch.Generator().manual_seed(1))

    orig, orig_mine = obj.compute_itm_hardneg, obj.mine_hard_negatives
    out = {}
    for mode in ("sharded", "whole"):
        tr = CoarseTrainer(cfg, device="cpu", seed=0, mesh=mesh)
        if mode == "whole":
            tr.queue = queue(cfg.itc_queue_size, None)
        seen, mined = [], []

        def record(model, batch, negatives, **kw):
            seen.append({k: v.clone() for k, v in negatives.items()})
            return orig(model, batch, negatives, **kw)

        def mine(*a, **kw):
            mined.append(orig_mine(*a, **kw))
            return mined[-1]

        obj.compute_itm_hardneg, obj.mine_hard_negatives = record, mine
        metrics = [tr.train_step(_local(b, world, rank))
                   for b in inp["batches"]]
        obj.compute_itm_hardneg, obj.mine_hard_negatives = orig, orig_mine
        q = tr.queue
        out[mode] = {"negatives": seen, "metrics": metrics, "mined": mined,
                     "state": q.state_dict(), "sharded": q.sharded,
                     "lo": q.lo, "input_bytes": q.input_bytes(),
                     "block": {k: getattr(q, k).clone()
                               for k in INPUT_RINGS}}
    restored = queue(cfg.itc_queue_size, group)
    restored.load_state_dict(out["whole"]["state"])
    out["restored"] = restored.state_dict()
    out["restored_block"] = {k: getattr(restored, k).clone()
                             for k in INPUT_RINGS}
    odd = queue(cfg.itc_queue_size - 1, group)
    out["odd"] = (odd.sharded, odd.image_inputs.shape[0], odd.size)
    return out


SCENARIOS = {f.__name__: f for f in (multihost_helpers, coarse_step,
                                     coarse_tasks, coarse_resume,
                                     detection_step, tp_step,
                                     sharded_queue)}


def main() -> None:
    scenario, rank, world, d = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    if os.environ.get("FIBER_COORDINATOR"):
        multihost.maybe_initialize_distributed(backend="gloo", timeout_s=120)
    else:
        multihost.maybe_initialize_distributed(
            f"file://{d}/rendezvous", world, rank, backend="gloo",
            timeout_s=120)
    inp = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    out = SCENARIOS[scenario](inp, rank, world)
    torch.save(out, os.path.join(d, f"out_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
