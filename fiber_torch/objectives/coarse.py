"""Coarse-grained training objectives: MLM, ITC with its queue and
hard-negative mining, ITM, VQA, NLVR2, and their sum for pretraining.

The PyTorch counterpart of `fiber_tpu/objectives/coarse.py`.  Each function
takes the model and a batch dict of device tensors:

  image:        (B, S, S, 3) float NHWC, normalised
  text_ids:     (B, L) int,  text_masks: (B, L) int
  text_ids_mlm / text_labels_mlm    (MLM; labels use -100 to ignore)
  vqa_targets:  (B, num_answers) soft scores              (VQA)
  image_0 / image_1, answers                              (NLVR2)
  image, text_ids, text_masks                             (caption MLE)

Dropout follows the model's mode (`model.train()`); the losses themselves
are computed in fp32 with autocast off.  Random draws (the mined
negatives, the random ITM pairs) come from a `torch.Generator`, not from
`jax.random`, so they differ from the JAX package's draws: a test hands
both packages the same negatives.  The other caption losses (gold, SCST)
are in `fiber_torch/objectives/caption.py`.

Data parallel: with a process `group` each rank holds its B / R rows of
the global batch and every loss is its partial, the local sum over the
global count, so that the sum over ranks is the JAX package's loss on the
global batch (`fiber_torch/parallel/data_parallel.py`).  The ITC columns,
the hard negatives and the queue's rows are those of the global batch
(the queue's input rings may be split over the ranks:
`fiber_torch/parallel/itc_queue.py`); every draw is made for the global
batch from a generator seeded alike on every rank, and each rank keeps
its rows, so the draws do not depend on R.
Every rank's local batch has the same size.  With no group the helpers are
the identity.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fiber_torch.parallel.data_parallel import (all_gather_rows,
                                                global_count, rank_world)
from fiber_torch.parallel.itc_queue import ItcQueue

IGNORE_INDEX = -100
Batch = Dict[str, torch.Tensor]


def _fp32(device: torch.device) -> torch.autocast:
    return torch.autocast(device.type, enabled=False)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = IGNORE_INDEX, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over positions whose label != ignore_index, and
    the accuracy there, both fp32; under `group` the mean's count is the
    count over every rank."""
    with _fp32(logits.device):
        logits = logits.float()
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        denom = global_count(valid.sum(), group).clamp(min=1)
        loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
        acc = (valid & (logits.argmax(-1) == safe)).sum() / denom
    return loss, acc


# ---------------------------------------------------------------------------
def compute_mlm(model, batch: Batch, group=None) -> Dict[str, torch.Tensor]:
    out = model.infer(batch["image"], batch["text_ids_mlm"],
                      batch["text_masks"])
    logits = model.mlm_logits(out["text_feats"])
    loss, acc = cross_entropy_ignore(logits, batch["text_labels_mlm"],
                                     group=group)
    return {"mlm_loss": loss, "mlm_accuracy": acc}


# ---------------------------------------------------------------------------
def mine_hard_negatives(sim: torch.Tensor, valid: torch.Tensor,
                        generator: Optional[torch.Generator], row0: int = 0,
                        total_rows: Optional[int] = None) -> torch.Tensor:
    """One column per row of `sim` (B, M), drawn with probability
    softmax(sim) over the columns < `valid` other than the row's own
    (the diagonal).  No gradient.  Gumbel-max, as `jax.random.categorical`
    draws: argmax of sim + Gumbel noise over the allowed columns (a
    non-finite similarity still yields an allowed column).

    The rows of `sim` may be rows row0 .. row0 + B of a global batch of
    `total_rows`: the noise is then drawn for all of them and these rows
    kept, and row i's own column is row0 + i."""
    B, M = sim.shape
    col = torch.arange(M, device=sim.device)
    own = row0 + col[:B]
    ok = (col[None, :] < valid) & (col[None, :] != own[:, None])
    u = torch.rand((total_rows or B, M), device=sim.device,
                   generator=generator)[row0:row0 + B]
    score = sim.detach().float() - torch.log(-torch.log(u))
    return torch.where(ok, score, -torch.inf).argmax(dim=-1)


def _dual_gather(batch_arr: torch.Tensor, queue_arr,
                 idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of [batch | queue] without building the concatenation
    (the raw-image queue is 3.6 GB at 4096 x 384^2 bf16): two bounded
    gathers and a select touch only B rows.  `queue_arr` is a ring or
    `ItcQueue.ring`'s view of a sharded one."""
    B, Q = batch_arr.shape[0], queue_arr.shape[0]
    from_batch = batch_arr[idx.clamp(0, B - 1)]
    from_queue = queue_arr[(idx - B).clamp(0, Q - 1)].to(batch_arr.dtype)
    sel = (idx < B).reshape((-1,) + (1,) * (batch_arr.dim() - 1))
    return torch.where(sel, from_batch, from_queue)


def compute_itc(model, batch: Batch, queue: ItcQueue,
                generator: Optional[torch.Generator], train: bool = True,
                group=None) -> Tuple[Dict[str, torch.Tensor], Batch]:
    """ALBEF-style contrastive loss over [global batch | queue] columns with
    the clamped temperature, plus hard-negative mining for ITM.

    Returns (out, negatives); with `train` the global batch is then
    enqueued (in place, in rank order), after the negatives were gathered
    from the queue as it was."""
    img, ids, masks = batch["image"], batch["text_ids"], batch["text_masks"]
    B = img.shape[0]
    rank, world = rank_world(group)
    Bg, row0 = B * world, rank * B
    image_feat = model.encode_image_itc(img)["cls_feats"].float()
    text_feat = model.encode_text_itc(ids, masks)["cls_feats"].float()
    temp = model.itc_temperature()
    # the global batch, without gradient (the columns stop it in JAX too)
    image_feats_g = all_gather_rows(image_feat, group)
    text_feats_g = all_gather_rows(text_feat, group)

    with _fp32(img.device):
        # the unfilled random queue slots take part in the denominator, as
        # in the reference (the whole 4096-slot buffer)
        text_all = torch.cat([text_feats_g.detach(), queue.text_feats])
        image_all = torch.cat([image_feats_g.detach(), queue.image_feats])
        sim_i2t = image_feat @ text_all.T / temp          # (B, Bg + Q)
        sim_t2i = text_feat @ image_all.T / temp
        labels = row0 + torch.arange(B, device=img.device)
        itc_loss = 0.5 * (F.cross_entropy(sim_i2t, labels, reduction="sum")
                          + F.cross_entropy(sim_t2i, labels,
                                            reduction="sum")) / Bg

    valid = Bg + queue.valid_count()
    shard = {} if group is None else dict(row0=row0, total_rows=Bg)
    idx_t2i = mine_hard_negatives(sim_t2i, valid, generator, **shard)
    idx_i2t = mine_hard_negatives(sim_i2t, valid, generator, **shard)
    img_g, ids_g, masks_g = (all_gather_rows(x, group)
                             for x in (img, ids, masks))
    rows = slice(None)
    if queue.sharded:
        # the input rings are split over the ranks: every rank reads the
        # whole batch's negatives (one collective a ring), keeps its rows
        idx_t2i, idx_i2t = (all_gather_rows(i, group)
                            for i in (idx_t2i, idx_i2t))
        rows = slice(row0, row0 + B)
    negatives = {
        "image_neg": _dual_gather(img_g, queue.ring("image_inputs"),
                                  idx_t2i)[rows],
        "text_neg": _dual_gather(ids_g, queue.ring("text_inputs"),
                                 idx_i2t)[rows],
        "text_mask_neg": _dual_gather(masks_g, queue.ring("text_masks"),
                                      idx_i2t)[rows],
    }
    if train:
        queue.enqueue(image_feats_g, text_feats_g, img_g, ids_g, masks_g)
    return {"itc_loss": itc_loss}, negatives


# ---------------------------------------------------------------------------
def compute_itm_hardneg(model, batch: Batch, negatives: Batch,
                        chunk: bool = False, group=None
                        ) -> Dict[str, torch.Tensor]:
    """ITM on the [positive | text negative | image negative] triple batch.
    `chunk` runs three B-image forwards instead of one 3B-image forward:
    the same losses without dropout."""
    img, ids, masks = batch["image"], batch["text_ids"], batch["text_masks"]
    B = img.shape[0]
    labels = torch.cat([torch.ones(B, dtype=torch.long, device=img.device),
                        torch.zeros(2 * B, dtype=torch.long,
                                    device=img.device)])
    images = (img, img, negatives["image_neg"])
    texts = (ids, negatives["text_neg"], ids)
    text_masks = (masks, negatives["text_mask_neg"], masks)
    if chunk:
        logits = torch.cat([
            model.itm_logits(model.infer(im, ti, tm)["cls_feats"])
            for im, ti, tm in zip(images, texts, text_masks)])
    else:
        out = model.infer(torch.cat(images), torch.cat(texts),
                          torch.cat(text_masks))
        logits = model.itm_logits(out["cls_feats"])
    loss, acc = cross_entropy_ignore(logits, labels, group=group)
    return {"itm_loss": loss, "itm_accuracy": acc}


def compute_itm_random(model, batch: Batch,
                       generator: Optional[torch.Generator], group=None
                       ) -> Dict[str, torch.Tensor]:
    """ITM with in-batch false images: the global batch rolled by a random
    non-zero offset, swapped in where a fair coin says so."""
    img = batch["image"]
    B = img.shape[0]
    rank, world = rank_world(group)
    Bg, dev = B * world, img.device
    img_g = all_gather_rows(img, group)
    offset = torch.randint(1, Bg, (), device=dev, generator=generator)
    rows = rank * B + torch.arange(B, device=dev)
    false_img = img_g[(rows - offset) % Bg]
    labels = (torch.rand(Bg, device=dev, generator=generator)
              < 0.5).long()[rows]
    mixed = torch.where(labels[:, None, None, None] == 1, img, false_img)
    out = model.infer(mixed, batch["text_ids"], batch["text_masks"])
    loss, acc = cross_entropy_ignore(model.itm_logits(out["cls_feats"]),
                                     labels, group=group)
    return {"itm_loss": loss, "itm_accuracy": acc}


# ---------------------------------------------------------------------------
def compute_vqa(model, batch: Batch, group=None) -> Dict[str, torch.Tensor]:
    """BCE over the answers, scaled by the answer count (so a sum over the
    answers, a mean over the global batch); the score is the soft target
    mass at the argmax answer."""
    out = model.infer(batch["image"], batch["text_ids"], batch["text_masks"])
    logits = model.vqa_logits(out["cls_feats"])
    with _fp32(logits.device):
        logits = logits.float()
        targets = batch["vqa_targets"].float()
        bce = (logits.clamp(min=0) - logits * targets
               + torch.log1p(torch.exp(-logits.abs())))
        Bg = targets.shape[0] * rank_world(group)[1]
        loss = bce.sum() / Bg
        score = targets.gather(1, logits.argmax(-1)[:, None]).sum() / Bg
    return {"vqa_loss": loss, "vqa_score": score}


def compute_nlvr2(model, batch: Batch, group=None) -> Dict[str, torch.Tensor]:
    """Two-image reasoning: both fused forwards' cls features, joined."""
    out1 = model.infer(batch["image_0"], batch["text_ids"],
                       batch["text_masks"])
    out2 = model.infer(batch["image_1"], batch["text_ids"],
                       batch["text_masks"])
    cls = torch.cat([out1["cls_feats"], out2["cls_feats"]], dim=-1)
    loss, acc = cross_entropy_ignore(model.nlvr2_logits(cls), batch["answers"],
                                     group=group)
    return {"nlvr2_loss": loss, "nlvr2_accuracy": acc}


# ---------------------------------------------------------------------------
def compute_caption_mle(model, batch: Batch, pad_token_id: int = 1,
                        group=None) -> Dict[str, torch.Tensor]:
    """Next-token cross-entropy of the causal decoder over the image's
    caption features: the labels are the ids shifted left with PAD at the
    end, PAD ignored."""
    img_emb = model.encode_image_caption(batch["image"])
    out = model.infer_caption(batch["text_ids"], batch["text_masks"], img_emb)
    logits = model.mlm_logits(out["text_feats"])
    labels = shift_labels(batch["text_ids"], pad_token_id)
    labels = labels.masked_fill(labels == pad_token_id, IGNORE_INDEX)
    loss, acc = cross_entropy_ignore(logits, labels, group=group)
    return {"caption_mle_loss": loss, "caption_mle_accuracy": acc}


def shift_labels(ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """The next token at each position: ids shifted left, PAD last."""
    return torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], pad_id)], dim=1)


# ---------------------------------------------------------------------------
def pretrain_losses(model, batch: Batch, queue: Optional[ItcQueue],
                    generator: Optional[torch.Generator],
                    loss_names: Sequence[str], train: bool = True,
                    itm_hardneg_chunk: bool = False, group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MLM + ITC (+ queue) + hard-negative ITM (+ VQA, NLVR2, caption
    MLE), summed.  Returns (total, metrics); with `train` and ITC on, the
    queue has taken the (global) batch.  Under `group` the losses and
    metrics are this rank's partials: their sums over the ranks are the
    global batch's."""
    out: Dict[str, torch.Tensor] = {}
    negatives = None
    if "mlm" in loss_names:
        out.update(compute_mlm(model, batch, group=group))
    if "itc" in loss_names:
        itc_out, negatives = compute_itc(model, batch, queue, generator,
                                         train=train, group=group)
        out.update(itc_out)
    if "itm" in loss_names:
        if negatives is not None:
            out.update(compute_itm_hardneg(model, batch, negatives,
                                           chunk=itm_hardneg_chunk,
                                           group=group))
        else:
            out.update(compute_itm_random(model, batch, generator,
                                          group=group))
    if "vqa" in loss_names:
        out.update(compute_vqa(model, batch, group=group))
    if "nlvr2" in loss_names:
        out.update(compute_nlvr2(model, batch, group=group))
    if "caption_mle" in loss_names:
        out.update(compute_caption_mle(model, batch, group=group))
    total = sum(v for k, v in out.items() if k.endswith("_loss"))
    return total, out
