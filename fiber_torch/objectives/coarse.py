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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fiber_torch.parallel.itc_queue import ItcQueue

IGNORE_INDEX = -100
Batch = Dict[str, torch.Tensor]


def _fp32(device: torch.device) -> torch.autocast:
    return torch.autocast(device.type, enabled=False)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = IGNORE_INDEX
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over positions whose label != ignore_index, and
    the accuracy there, both fp32."""
    with _fp32(logits.device):
        logits = logits.float()
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        denom = valid.sum().clamp(min=1)
        loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
        acc = (valid & (logits.argmax(-1) == safe)).sum() / denom
    return loss, acc


# ---------------------------------------------------------------------------
def compute_mlm(model, batch: Batch) -> Dict[str, torch.Tensor]:
    out = model.infer(batch["image"], batch["text_ids_mlm"],
                      batch["text_masks"])
    logits = model.mlm_logits(out["text_feats"])
    loss, acc = cross_entropy_ignore(logits, batch["text_labels_mlm"])
    return {"mlm_loss": loss, "mlm_accuracy": acc}


# ---------------------------------------------------------------------------
def mine_hard_negatives(sim: torch.Tensor, valid: torch.Tensor,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """One column per row of `sim` (B, M), drawn with probability
    softmax(sim) over the columns < `valid` other than the row's own
    (the diagonal).  No gradient.  Gumbel-max, as `jax.random.categorical`
    draws: argmax of sim + Gumbel noise over the allowed columns (a
    non-finite similarity still yields an allowed column)."""
    B, M = sim.shape
    col = torch.arange(M, device=sim.device)
    ok = (col[None, :] < valid) & (col[None, :] != col[:B, None])
    u = torch.rand((B, M), device=sim.device, generator=generator)
    score = sim.detach().float() - torch.log(-torch.log(u))
    return torch.where(ok, score, -torch.inf).argmax(dim=-1)


def _dual_gather(batch_arr: torch.Tensor, queue_arr: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of [batch | queue] without building the concatenation
    (the raw-image queue is 3.6 GB at 4096 x 384^2 bf16): two bounded
    gathers and a select touch only B rows."""
    B, Q = batch_arr.shape[0], queue_arr.shape[0]
    from_batch = batch_arr[idx.clamp(0, B - 1)]
    from_queue = queue_arr[(idx - B).clamp(0, Q - 1)].to(batch_arr.dtype)
    sel = (idx < B).reshape((-1,) + (1,) * (batch_arr.dim() - 1))
    return torch.where(sel, from_batch, from_queue)


def compute_itc(model, batch: Batch, queue: ItcQueue,
                generator: Optional[torch.Generator], train: bool = True
                ) -> Tuple[Dict[str, torch.Tensor], Batch]:
    """ALBEF-style contrastive loss over [batch | queue] columns with the
    clamped temperature, plus hard-negative mining for ITM.

    Returns (out, negatives); with `train` the batch is then enqueued (in
    place), after the negatives were gathered from the queue as it was."""
    img, ids, masks = batch["image"], batch["text_ids"], batch["text_masks"]
    B = img.shape[0]
    image_feat = model.encode_image_itc(img)["cls_feats"].float()
    text_feat = model.encode_text_itc(ids, masks)["cls_feats"].float()
    temp = model.itc_temperature()

    with _fp32(img.device):
        # the unfilled random queue slots take part in the denominator, as
        # in the reference (the whole 4096-slot buffer)
        text_all = torch.cat([text_feat.detach(), queue.text_feats])
        image_all = torch.cat([image_feat.detach(), queue.image_feats])
        sim_i2t = image_feat @ text_all.T / temp          # (B, B + Q)
        sim_t2i = text_feat @ image_all.T / temp
        labels = torch.arange(B, device=img.device)
        itc_loss = 0.5 * (F.cross_entropy(sim_i2t, labels)
                          + F.cross_entropy(sim_t2i, labels))

    valid = B + queue.valid_count()
    idx_t2i = mine_hard_negatives(sim_t2i, valid, generator)  # images
    idx_i2t = mine_hard_negatives(sim_i2t, valid, generator)  # texts
    negatives = {
        "image_neg": _dual_gather(img, queue.image_inputs, idx_t2i),
        "text_neg": _dual_gather(ids, queue.text_inputs, idx_i2t),
        "text_mask_neg": _dual_gather(masks, queue.text_masks, idx_i2t),
    }
    if train:
        queue.enqueue(image_feat, text_feat, img, ids, masks)
    return {"itc_loss": itc_loss}, negatives


# ---------------------------------------------------------------------------
def compute_itm_hardneg(model, batch: Batch, negatives: Batch,
                        chunk: bool = False) -> Dict[str, torch.Tensor]:
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
    loss, acc = cross_entropy_ignore(logits, labels)
    return {"itm_loss": loss, "itm_accuracy": acc}


def compute_itm_random(model, batch: Batch,
                       generator: Optional[torch.Generator]
                       ) -> Dict[str, torch.Tensor]:
    """ITM with in-batch false images: the batch rolled by a random
    non-zero offset, swapped in where a fair coin says so."""
    img = batch["image"]
    B = img.shape[0]
    dev = img.device
    offset = torch.randint(1, B, (), device=dev, generator=generator)
    false_img = img[(torch.arange(B, device=dev) - offset) % B]
    labels = (torch.rand(B, device=dev, generator=generator) < 0.5).long()
    mixed = torch.where(labels[:, None, None, None] == 1, img, false_img)
    out = model.infer(mixed, batch["text_ids"], batch["text_masks"])
    loss, acc = cross_entropy_ignore(model.itm_logits(out["cls_feats"]),
                                     labels)
    return {"itm_loss": loss, "itm_accuracy": acc}


# ---------------------------------------------------------------------------
def compute_vqa(model, batch: Batch) -> Dict[str, torch.Tensor]:
    """BCE over the answers, scaled by the answer count; the score is the
    soft target mass at the argmax answer."""
    out = model.infer(batch["image"], batch["text_ids"], batch["text_masks"])
    logits = model.vqa_logits(out["cls_feats"])
    with _fp32(logits.device):
        logits = logits.float()
        targets = batch["vqa_targets"].float()
        bce = (logits.clamp(min=0) - logits * targets
               + torch.log1p(torch.exp(-logits.abs())))
        loss = bce.mean() * targets.shape[1]
        score = targets.gather(1, logits.argmax(-1)[:, None]).mean()
    return {"vqa_loss": loss, "vqa_score": score}


def compute_nlvr2(model, batch: Batch) -> Dict[str, torch.Tensor]:
    """Two-image reasoning: both fused forwards' cls features, joined."""
    out1 = model.infer(batch["image_0"], batch["text_ids"],
                       batch["text_masks"])
    out2 = model.infer(batch["image_1"], batch["text_ids"],
                       batch["text_masks"])
    cls = torch.cat([out1["cls_feats"], out2["cls_feats"]], dim=-1)
    loss, acc = cross_entropy_ignore(model.nlvr2_logits(cls), batch["answers"])
    return {"nlvr2_loss": loss, "nlvr2_accuracy": acc}


# ---------------------------------------------------------------------------
def compute_caption_mle(model, batch: Batch, pad_token_id: int = 1
                        ) -> Dict[str, torch.Tensor]:
    """Next-token cross-entropy of the causal decoder over the image's
    caption features: the labels are the ids shifted left with PAD at the
    end, PAD ignored."""
    img_emb = model.encode_image_caption(batch["image"])
    out = model.infer_caption(batch["text_ids"], batch["text_masks"], img_emb)
    logits = model.mlm_logits(out["text_feats"])
    labels = shift_labels(batch["text_ids"], pad_token_id)
    labels = labels.masked_fill(labels == pad_token_id, IGNORE_INDEX)
    loss, acc = cross_entropy_ignore(logits, labels)
    return {"caption_mle_loss": loss, "caption_mle_accuracy": acc}


def shift_labels(ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """The next token at each position: ids shifted left, PAD last."""
    return torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], pad_id)], dim=1)


# ---------------------------------------------------------------------------
def pretrain_losses(model, batch: Batch, queue: Optional[ItcQueue],
                    generator: Optional[torch.Generator],
                    loss_names: Sequence[str], train: bool = True,
                    itm_hardneg_chunk: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MLM + ITC (+ queue) + hard-negative ITM (+ VQA, NLVR2, caption
    MLE), summed.  Returns (total, metrics); with `train` and ITC on, the
    queue has taken the batch."""
    out: Dict[str, torch.Tensor] = {}
    negatives = None
    if "mlm" in loss_names:
        out.update(compute_mlm(model, batch))
    if "itc" in loss_names:
        itc_out, negatives = compute_itc(model, batch, queue, generator,
                                         train=train)
        out.update(itc_out)
    if "itm" in loss_names:
        if negatives is not None:
            out.update(compute_itm_hardneg(model, batch, negatives,
                                           chunk=itm_hardneg_chunk))
        else:
            out.update(compute_itm_random(model, batch, generator))
    if "vqa" in loss_names:
        out.update(compute_vqa(model, batch))
    if "nlvr2" in loss_names:
        out.update(compute_nlvr2(model, batch))
    if "caption_mle" in loss_names:
        out.update(compute_caption_mle(model, batch))
    total = sum(v for k, v in out.items() if k.endswith("_loss"))
    return total, out
