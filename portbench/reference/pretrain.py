"""The pretraining step of the reference: MLM + ITC with its queue +
hard-negative ITM, summed, then AdamW in FIBER's six groups.

A plain fp32 copy of the arithmetic of `fiber_torch/objectives/coarse.py`
(`pretrain_losses` with one process) and `fiber_torch/train/optim.py`,
written against nothing of the port.  Two seeds the reference takes as
given, because they drive draws: the dropout generator's (the model's
modules draw their masks from it in the program's order) and the mining
noise's.  The reference mines its own negatives, a Gumbel-max over its
own fp32 similarities under the same noise, and judges the program's
columns by how far each lies below its row's best there (`mine_gap`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

IGNORE_INDEX = -100
HEAD_NAMES = ("vqa_classifier", "nlvr2_classifier", "mlm_score", "itm_score")
CROSS_MODAL_NAMES = ("cross_modal", "i2t", "t2i")


# ---------------------------------------------------------------------------
class Queue:
    """The ITC queue: feature rings (fp32) and raw-input rings, a pointer
    and a lifetime count."""

    def __init__(self, image_feats, text_feats, image_inputs, text_inputs,
                 text_masks, total: int):
        self.image_feats, self.text_feats = image_feats, text_feats
        self.image_inputs, self.text_inputs = image_inputs, text_inputs
        self.text_masks = text_masks
        self.ptr, self.total = 0, total

    @property
    def size(self) -> int:
        return self.image_feats.shape[0]

    def valid_count(self) -> int:
        return min(self.total, self.size)

    @torch.no_grad()
    def enqueue(self, image_feat, text_feat, image_input, text_input,
                text_mask) -> None:
        B = image_feat.shape[0]
        idx = (self.ptr + torch.arange(B, device=image_feat.device)) % self.size
        for ring, x in ((self.image_feats, image_feat.float()),
                        (self.text_feats, text_feat.float()),
                        (self.image_inputs, image_input),
                        (self.text_inputs, text_input),
                        (self.text_masks, text_mask)):
            ring.index_copy_(0, idx, x.to(ring.dtype))
        self.ptr = (self.ptr + B) % self.size
        self.total += B


def cross_entropy_ignore(logits, labels) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not ignored."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.log_softmax(logits.float(), -1).gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / valid.sum().clamp(min=1)


def _gather(batch_arr, ring, idx) -> torch.Tensor:
    """Rows `idx` of [batch | ring]."""
    B = batch_arr.shape[0]
    from_batch = batch_arr[idx.clamp(0, B - 1)]
    from_ring = ring[(idx - B).clamp(0, ring.shape[0] - 1)].to(batch_arr.dtype)
    sel = (idx < B).reshape((-1,) + (1,) * (batch_arr.dim() - 1))
    return torch.where(sel, from_batch, from_ring)


def mine(sim: torch.Tensor, valid: int, judged: Optional[torch.Tensor],
         generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(columns, gap): the reference's own Gumbel-max over each row's
    allowed columns (< `valid`, not the row's own), the noise drawn as the
    program draws it, and the widest gap by which a `judged` column (the
    program's) lies below its row's best score: 0 with none judged, inf
    where `judged` is not one column a row."""
    B, M = sim.shape
    col = torch.arange(M, device=sim.device)
    ok = (col[None, :] < valid) & (col[None, :] != col[:B, None])
    u = torch.rand((B, M), device=sim.device, generator=generator)
    score = torch.where(ok, sim.detach().float() - torch.log(-torch.log(u)),
                        -torch.inf)
    own = score.argmax(1)
    if judged is None:
        return own, score.new_zeros(())
    if judged.shape != own.shape:
        return own, score.new_full((), torch.inf)
    got = score.gather(1, judged[:, None].to(own.device))[:, 0]
    return own, (score.amax(1) - got).amax()


def pretrain_losses(model, batch: Dict[str, torch.Tensor], queue: Queue,
                    judged: Optional[Tuple[torch.Tensor, torch.Tensor]],
                    mine_generator: torch.Generator
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {mlm_loss, itc_loss, itm_loss, mine_gap, chosen}) of one
    batch, in the program's order of forwards; the queue then takes the
    batch.  The negatives are the reference's own; `judged` holds the
    program's (t2i, i2t) columns for `mine_gap`, or None."""
    img, ids, masks = batch["image"], batch["text_ids"], batch["text_masks"]
    B = img.shape[0]
    out = {}
    fused = model.infer(img, batch["text_ids_mlm"], masks)
    out["mlm_loss"] = cross_entropy_ignore(model.mlm_logits(fused["text_feats"]),
                                           batch["text_labels_mlm"])

    image_feat = model.encode_image_itc(img)["cls_feats"].float()
    text_feat = model.encode_text_itc(ids, masks)["cls_feats"].float()
    temp = model.itc_temperature()
    text_all = torch.cat([text_feat.detach(), queue.text_feats])
    image_all = torch.cat([image_feat.detach(), queue.image_feats])
    sim_i2t = image_feat @ text_all.T / temp
    sim_t2i = text_feat @ image_all.T / temp
    labels = torch.arange(B, device=img.device)
    out["itc_loss"] = 0.5 * (F.cross_entropy(sim_i2t, labels, reduction="sum")
                             + F.cross_entropy(sim_t2i, labels,
                                               reduction="sum")) / B
    valid = B + queue.valid_count()
    idx_t2i, gap_t2i = mine(sim_t2i, valid, judged and judged[0],
                            mine_generator)
    idx_i2t, gap_i2t = mine(sim_i2t, valid, judged and judged[1],
                            mine_generator)
    gap = torch.maximum(gap_t2i, gap_i2t)
    image_neg = _gather(img, queue.image_inputs, idx_t2i)
    text_neg = _gather(ids, queue.text_inputs, idx_i2t)
    mask_neg = _gather(masks, queue.text_masks, idx_i2t)
    queue.enqueue(image_feat, text_feat, img, ids, masks)

    itm_labels = torch.cat([torch.ones(B, dtype=torch.long, device=img.device),
                            torch.zeros(2 * B, dtype=torch.long,
                                        device=img.device)])
    triple = model.infer(torch.cat([img, img, image_neg]),
                         torch.cat([ids, text_neg, ids]),
                         torch.cat([masks, mask_neg, masks]))
    out["itm_loss"] = cross_entropy_ignore(model.itm_logits(triple["cls_feats"]),
                                           itm_labels)
    total = out["mlm_loss"] + out["itc_loss"] + out["itm_loss"]
    out["mine_gap"] = gap
    out["chosen"] = (idx_t2i, idx_i2t)
    return total, out


# ---------------------------------------------------------------------------
def param_group(name: str, module: nn.Module) -> str:
    """FIBER's optimizer group of parameter `name` of `module`: head or
    cross-modal (or base) by its path, no decay for biases and for the
    norms whose path names a norm.  The MLM head's LayerNorm is
    `transform_ln` in the JAX package, which names no norm: its scale
    decays."""
    is_head = any(h in name for h in HEAD_NAMES)
    is_cross = any(c in name for c in CROSS_MODAL_NAMES)
    leaf = name.rpartition(".")[2]
    no_decay = leaf == "bias" or (isinstance(module, nn.LayerNorm)
                                  and not name.startswith("mlm_score."))
    grp = ("head" if is_head and not is_cross
           else "cross" if is_cross and not is_head else "base")
    return f"{grp}_{'nodecay' if no_decay else 'decay'}"


def make_optimizer(model: nn.Module, opt: Dict) -> torch.optim.AdamW:
    """AdamW in the six groups; each group keeps its peak lr."""
    owner = {id(p): m for m in model.modules() for p in m.parameters(recurse=False)}
    members: Dict[str, List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        members.setdefault(param_group(name, owner[id(p)]), []).append(p)
    mult = {"base": 1.0, "head": opt["lr_mult_head"],
            "cross": opt["lr_mult_cross_modal"]}
    groups = [dict(params=ps, name=g,
                   base_lr=opt["learning_rate"] * mult[g.split("_")[0]],
                   weight_decay=0.0 if g.endswith("_nodecay")
                   else opt["weight_decay"])
              for g, ps in sorted(members.items())]
    return torch.optim.AdamW(groups, lr=0.0,
                             betas=(opt["adam_beta1"], opt["adam_beta2"]),
                             eps=opt["adam_eps"])


def lr_at(opt: Dict, base_lr: float, count: int) -> float:
    """Linear warmup from 0, then polynomial decay to `end_lr`."""
    warmup = opt["warmup_steps"]
    if count < warmup:
        return base_lr * count / warmup
    decay_steps = max(opt["max_steps"] - warmup, 1)
    t = min(max(count - warmup, 0), decay_steps)
    frac = 1.0 - t / decay_steps
    return ((base_lr - opt["end_lr"]) * frac ** float(opt["decay_power"])
            + opt["end_lr"])


def train_step(model, optimizer, opt: Dict, count: int, batch, queue,
               judged, mine_generator) -> Dict[str, torch.Tensor]:
    """One step (the program's negatives `judged`, not used): the losses, backward, a zero gradient for every parameter
    no loss reaches (AdamW still decays it), no update of a non-finite
    loss's gradient, AdamW at update `count`'s rates."""
    for p in model.parameters():
        p.grad = None
    total, out = pretrain_losses(model, batch, queue, judged, mine_generator)
    total.backward()
    finite = torch.isfinite(total)
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.masked_fill_(~finite, 0.0)
    for g in optimizer.param_groups:
        g["lr"] = lr_at(opt, g["base_lr"], count)
    optimizer.step()
    out["total_loss"] = total
    return {k: v if k == "chosen" else v.detach() for k, v in out.items()}


def first_grads(optimizer, names: Dict[int, str]) -> Dict[str, torch.Tensor]:
    """Each parameter's first gradient as AdamW took it, read back from its
    first moment after one step (m = (1 - beta1) g)."""
    out = {}
    for g in optimizer.param_groups:
        b1 = g["betas"][0]
        for p in g["params"]:
            out[names[id(p)]] = optimizer.state[p]["exp_avg"] / (1.0 - b1)
    return out
