"""Pretraining: a closed loop of `CoarseTrainer.train_step` (MLM + ITC
with the queue + hard-negative ITM, backward, AdamW) on a fixed pool of
seeded batches, the queue full from the start.

Set-up builds the trainer, loads the run's weights, fills the queue, sets
the schedule's step, and drives the trainer through its first steps (the
reference's steps, which also warm every shape); the window then trains
on.  After the window the reference follows those first steps from the
same weights, queue, batches, dropout generator and mining noise (it
mines its own negatives), and the run compares each step's loss, each
leaf's first gradient (read back from AdamW's first moment), each leaf's
change over the steps, and how far each negative the program mined lies
below the reference's best under the same noise.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from portbench.harness import coarse, core, flops, traffic
from portbench.harness.coarse import NegativesSpy, leaf_norms


def _queue_rings(q) -> dict:
    return {k: getattr(q, k) for k in ("image_feats", "text_feats",
                                       "image_inputs", "text_inputs",
                                       "text_masks")}


def run(ctx) -> dict:
    cfg_file, tr, dev = ctx.config, ctx.traffic, ctx.device
    m, B, steps0 = cfg_file["model"], tr["batch"], tr["reference_steps"]
    seeds = {k: core.derive(ctx.seed, k)
             for k in ("data", "queue", "dropout", "mine")}
    batches = traffic.pretrain_batches(
        seeds["data"], m, tr, coarse.DTYPES[cfg_file["numerics"]["compute_dtype"]],
        dev)
    if ctx.mode == "control":
        # the reference in float8 stands in the program's place
        prog = reference_steps(ctx, batches[:steps0], None, seeds,
                               control=True)
        ctx.start_window()
        window = {"attempted": 0, "failed": 0, "rates": {}, "peak_bytes": 0,
                  "device": {}, "work": {}}
    else:
        prog, window = program(ctx, batches, seeds)
    ref = reference_steps(ctx, batches[:steps0], prog["chosen"], seeds,
                          moved=prog["change"])
    readings = {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "grad_median": core.median_gap(prog["grad"], ref["grad"]),
        "change_gap": core.norm_gap(ref["moved"], ref["change"])[0],
        "mine_gap": ref["mine_gap"],
        "grad_gap": core.norm_gap(prog["grad"], ref["grad"])[0]}
    print("detail " + json.dumps({
        "loss": [prog["loss"], ref["loss"]],
        "grad": core.worst_leaves(prog["grad"], ref["grad"]),
        "change": core.worst_leaves(ref["moved"], ref["change"])}),
        file=sys.stderr)
    return dict(window, readings=readings)


def program(ctx, batches, seeds):
    """The program's first steps (their losses, first gradients, changes
    and mined negatives) and its window."""
    from fiber_torch.objectives import coarse as objectives
    from fiber_torch.train.trainer import CoarseTrainer

    cfg_file, tr, dev = ctx.config, ctx.traffic, ctx.device
    m, B, steps0 = cfg_file["model"], tr["batch"], tr["reference_steps"]
    cfg = coarse.program_config(cfg_file)
    trainer = CoarseTrainer(cfg, device=dev, seed=seeds["dropout"])
    trainer.model.load_state_dict(coarse.weights(cfg_file, ctx.seed, dev))
    traffic.fill_queue(seeds["queue"], _queue_rings(trainer.queue), m, tr)
    trainer.queue.ptr.zero_()
    trainer.queue._ptr = 0
    trainer.queue.total.fill_(trainer.queue.size)
    trainer.step = tr["start_step"]
    mine = traffic.generator(seeds["mine"], dev)
    names = [n for n, _ in trainer.model.named_parameters()]
    params = [p for _, p in trainer.model.named_parameters()]

    # the reference's steps, which also warm every shape of the window
    spy = NegativesSpy(objectives)
    start = [p.detach().clone() for p in params]
    losses = []
    with spy:
        for i in range(steps0):
            losses.append(trainer.train_step(batches[i], mine)["total_loss"])
            if i == 0:
                b1 = trainer.cfg.adam_beta1
                state = trainer.optimizer.state
                grads = leaf_norms(      # nothing, where AdamW took nothing
                    names, [state[p]["exp_avg"] / (1 - b1) if state.get(p)
                            else torch.zeros_like(p) for p in params])
    with torch.no_grad():
        change = dict(zip(names, (d.cpu() for d in
                                  torch._foreach_sub(params, start))))
    del start
    prog = {"loss": torch.stack(losses).tolist(), "grad": grads,
            "change": change, "chosen": spy.chosen}

    ctx.start_window()
    window = []
    with ctx.trace:
        t0 = time.perf_counter()
        while True:
            b = batches[(steps0 + len(window)) % len(batches)]
            window.append(trainer.train_step(b, mine)["total_loss"])
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if dev != "cpu":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    n = len(window)
    failed = int((~torch.isfinite(torch.stack(window))).sum())
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    device = ctx_device(ctx, peak) if dev != "cpu" else {}
    del trainer, window
    if dev != "cpu":
        torch.cuda.empty_cache()
    k1, k2 = flops.pretrain_step_launches(m, B, cfg.remat)
    return prog, {
        "attempted": n * B, "failed": failed * B,
        "rates": {"train_samples_per_s": n * B / elapsed},
        "peak_bytes": peak, "device": device,
        "work": {"model_flops": n * flops.pretrain_step_flops(m, B),
                 "k1": k1 * n, "k2": k2 * n}}


def ctx_device(ctx, peak: int) -> dict:
    from portbench.harness.runner import device_info
    return device_info(ctx.cell["chips"], peak)


@torch.no_grad()
def kept_norms(first: dict, changes: dict, device) -> list:
    """The norms of each leaf's change over the elements whose reference
    gradient is at least a thousandth of the median leaf's root mean
    square: the others (a key's bias under softmax) move under AdamW by
    round-off alone.  One dict of norms for each dict of `changes`."""
    rms = sorted(float(g.norm()) / g.numel() ** 0.5 for g in first.values())
    floor = 1e-3 * rms[len(rms) // 2]
    keep = {n: g.abs() >= floor for n, g in first.items()}
    return [{n: float(torch.where(keep[n], d.to(device), 0).norm())
             for n, d in c.items() if keep[n].any()} for c in changes]


def reference_steps(ctx, batches, judged, seeds, control: bool = False,
                    moved: dict = None) -> dict:
    """The reference's first steps, fp32 (TF32 off), or float8 linears and
    convolutions for the control: each step's total loss, each leaf's
    first gradient, each leaf's change over the kept elements (and, over
    the same elements, that of the `moved` changes given), its own mined
    negatives, and the widest gap of the `judged` ones (the program's, a
    pair of columns a step).  With no `moved`, the changes themselves, on
    the host."""
    from portbench.reference import layers, pretrain
    dev = ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = coarse.reference_model(ctx.config, dev,
                                   remat=ctx.config["numerics"]["remat"])
    model.load_state_dict(coarse.weights(ctx.config, ctx.seed, dev))
    if control:
        layers.use_fp8(model)
    layers.set_generator(model, traffic.generator(seeds["dropout"], dev))
    model.train()
    m, tr = ctx.config["model"], ctx.traffic
    Q, S, L = m["itc_queue_size"], m["image_size"], m["max_text_len"]
    img_dtype = batches[0]["image"].dtype
    rings = {"image_feats": torch.empty(Q, m["hidden_size"], device=dev),
             "text_feats": torch.empty(Q, m["hidden_size"], device=dev),
             "image_inputs": torch.empty(Q, S, S, 3, dtype=img_dtype,
                                         device=dev),
             "text_inputs": torch.empty(Q, L, dtype=torch.long, device=dev),
             "text_masks": torch.empty(Q, L, dtype=torch.long, device=dev)}
    traffic.fill_queue(seeds["queue"], rings, m, tr)
    queue = pretrain.Queue(**rings, total=Q)
    opt_cfg = ctx.config["optimizer"]
    optimizer = pretrain.make_optimizer(model, opt_cfg)
    mine = traffic.generator(seeds["mine"], dev)
    names = {id(p): n for n, p in model.named_parameters()}
    order = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    losses, gaps = [], []
    used = []
    for i, b in enumerate(batches):
        batch = dict(b, image=b["image"].float())
        out = pretrain.train_step(model, optimizer, opt_cfg,
                                  tr["start_step"] + i, batch, queue,
                                  judged[i] if judged else None, mine)
        used.append(out["chosen"])
        losses.append(out["total_loss"])
        gaps.append(out["mine_gap"])
        if i == 0:
            first = {n: g.clone() for n, g in
                     pretrain.first_grads(optimizer, names).items()}
            grads = leaf_norms(order, [first[n] for n in order])
    with torch.no_grad():
        change = dict(zip(order, torch._foreach_sub(params, start)))
    out = {"loss": torch.stack(losses).tolist(), "grad": grads,
           "mine_gap": float(torch.stack(gaps).max()), "chosen": used}
    if moved is None:
        out["change"] = {n: d.cpu() for n, d in change.items()}
    else:
        out["change"], out["moved"] = kept_norms(first, [change, moved], dev)
    return out
