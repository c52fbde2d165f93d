"""Caption generation (greedy and beam-search decoding, the captioning
serving entry point) and the caption finetuning losses beyond MLE: "gold"
self-distillation and SCST with CIDEr-D rewards.

The PyTorch counterpart of `fiber_tpu/objectives/caption.py`.  The image
is encoded once (`FiberCoarse.encode_image_caption`) and reused every
step.  `greedy_decode` and `beam_search_decode` re-encode the whole prefix
each step, as the reference protocol does; they are the oracles of the
KV-cached `greedy_decode_cached` and `beam_search_decode_cached`, which
embed one token a step and attend over per-layer self-attention caches,
with the image K and V projected once per decode
(`FiberCoarse.decode_caption_step`).

Every loop runs a fixed max_len - 1 steps on the device: the step index is
a host integer and nothing is read back per token (no `.item()`, no
early exit), so the host never waits on the card inside a decode.
Finished sequences extend with PAD.  The decoders run under
`torch.inference_mode()` and need the model in eval mode.

The losses: `compute_caption_gold` weights each token's cross-entropy by a
frozen copy of the model (`gold_model`, which the caller refreshes from the
student); `compute_caption_cider` samples `num_samples` captions per image
(`sample_decode`: Gumbel-max draws from a `torch.Generator`, the same
draws as `jax.random.categorical` makes from its noise), reads them back
once, scores them on the host with CIDEr-D (`fiber_torch.native.CiderD`)
and takes `scst_loss`.  The caption MLE is
`fiber_torch.objectives.coarse.compute_caption_mle`.  Each loss enters
the model's autocast itself; the losses are computed in fp32.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.objectives.coarse import (IGNORE_INDEX, _fp32,
                                           cross_entropy_ignore, shift_labels)
from fiber_torch.objectives.retrieval import _check_serving

NEG_INF = -1e9


def _start(n: int, max_len: int, bos_id: int, pad_id: int,
           device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (n, max_len): BOS then PAD, done (n,) all False)."""
    ids = torch.full((n, max_len), pad_id, dtype=torch.long, device=device)
    ids[:, 0] = bos_id
    return ids, torch.zeros(n, dtype=torch.bool, device=device)


def _step_logits(model: FiberCoarse, ids: torch.Tensor,
                 image_embeds: torch.Tensor, pad_id: int,
                 pos: int) -> torch.Tensor:
    """The causal decoder on the PAD-masked prefix: the logits at `pos`,
    the next-token distribution (n, V)."""
    out = model.infer_caption(ids, (ids != pad_id).long(), image_embeds)
    return model.mlm_logits(out["text_feats"][:, pos:pos + 1])[:, 0]


def _greedy_step(logits: torch.Tensor, ids: torch.Tensor, done: torch.Tensor,
                 t: int, eos_id: int, pad_id: int) -> torch.Tensor:
    """Token t of every sequence: the argmax, PAD once finished.  Writes
    ids in place; returns the new done."""
    nxt = logits.argmax(-1)
    nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
    ids[:, t] = nxt
    return done | (nxt == eos_id)


@torch.inference_mode()
def greedy_decode(model: FiberCoarse, image_embeds: torch.Tensor, bos_id: int,
                  eos_id: int, pad_id: int, max_len: int) -> torch.Tensor:
    """(B, max_len) token ids, BOS first, PAD after EOS; the whole prefix
    re-encoded each step."""
    _check_serving(model)
    ids, done = _start(image_embeds.shape[0], max_len, bos_id, pad_id,
                       image_embeds.device)
    for t in range(1, max_len):
        logits = _step_logits(model, ids, image_embeds, pad_id, t - 1)
        done = _greedy_step(logits, ids, done, t, eos_id, pad_id)
    return ids


@torch.inference_mode()
def greedy_decode_cached(model: FiberCoarse, image_embeds: torch.Tensor,
                         bos_id: int, eos_id: int, pad_id: int,
                         max_len: int) -> torch.Tensor:
    """KV-cached greedy decode; token-identical to `greedy_decode`."""
    _check_serving(model)
    ids, done = _start(image_embeds.shape[0], max_len, bos_id, pad_id,
                       image_embeds.device)
    caches = model.init_caption_cache(image_embeds, max_len)
    for t in range(1, max_len):
        logits, caches = model.decode_caption_step(ids[:, t - 1:t], t - 1,
                                                   caches)
        done = _greedy_step(logits, ids, done, t, eos_id, pad_id)
    return ids


def _beam_start(image_embeds: torch.Tensor, beam_size: int, bos_id: int,
                pad_id: int, max_len: int):
    """The image features repeated per beam (B K, L, D), the ids and done
    flags of B K beams, and their log-probabilities: beam 0 of each image
    at 0, the others at NEG_INF, so that the first step picks K distinct
    tokens of beam 0."""
    B, K = image_embeds.shape[0], beam_size
    dev = image_embeds.device
    ids, done = _start(B * K, max_len, bos_id, pad_id, dev)
    logp = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    logp[:, 0] = 0.0
    return (image_embeds.repeat_interleave(K, dim=0), ids, logp.reshape(-1),
            done)


def _beam_step(logits: torch.Tensor, ids: torch.Tensor, logp: torch.Tensor,
               done: torch.Tensor, t: int, K: int, eos_id: int, pad_id: int):
    """One step of the search over (B K, V) logits: finished beams extend
    with PAD at zero cost, the top K of each image's K V candidates by
    total log-probability win.  Returns the winners' (ids with token t,
    log-probabilities, done flags) and the beam each came from (B K,)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    V = lsm.shape[-1]
    pad_only = torch.full((V,), NEG_INF, device=lsm.device)
    pad_only[pad_id] = 0.0
    lsm = torch.where(done[:, None], pad_only[None, :], lsm)
    B = lsm.shape[0] // K
    cand = (logp[:, None] + lsm).reshape(B, K * V)
    top_logp, top_idx = torch.topk(cand, K, dim=-1)
    base = torch.arange(B, device=lsm.device)[:, None] * K
    beam = (top_idx // V + base).reshape(-1)
    tok = (top_idx % V).reshape(-1)
    ids = ids.index_select(0, beam)
    ids[:, t] = tok
    done = done.index_select(0, beam) | (tok == eos_id) | (tok == pad_id)
    return ids, top_logp.reshape(-1), done, beam


def _best_beam(ids: torch.Tensor, logp: torch.Tensor, K: int, pad_id: int,
               length_penalty: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each image's beam of the best length-normalised log-probability:
    (ids (B, max_len), score (B,))."""
    lengths = (ids != pad_id).sum(-1).float()
    norm = (logp / lengths ** length_penalty).reshape(-1, K)
    best = norm.argmax(-1)
    rows = torch.arange(norm.shape[0], device=ids.device)
    return ids.reshape(norm.shape[0], K, -1)[rows, best], norm[rows, best]


@torch.inference_mode()
def beam_search_decode(model: FiberCoarse, image_embeds: torch.Tensor,
                       bos_id: int, eos_id: int, pad_id: int, max_len: int,
                       beam_size: int = 5, length_penalty: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Length-normalised beam search, the whole prefix re-encoded each
    step.  Returns (ids (B, max_len) of the best beam, its score (B,))."""
    _check_serving(model)
    img, ids, logp, done = _beam_start(image_embeds, beam_size, bos_id,
                                       pad_id, max_len)
    for t in range(1, max_len):
        logits = _step_logits(model, ids, img, pad_id, t - 1)
        ids, logp, done, _ = _beam_step(logits, ids, logp, done, t,
                                        beam_size, eos_id, pad_id)
    return _best_beam(ids, logp, beam_size, pad_id, length_penalty)


def _reorder(caches: List[dict], beam: torch.Tensor) -> List[dict]:
    """The self-attention caches gathered along the winning beams; the
    image K and V are the same within an image's beams and stay."""
    return [{"self_kv": tuple(x.index_select(0, beam) for x in c["self_kv"]),
             "image_kv": c["image_kv"]} for c in caches]


@torch.inference_mode()
def beam_search_decode_cached(model: FiberCoarse, image_embeds: torch.Tensor,
                              bos_id: int, eos_id: int, pad_id: int,
                              max_len: int, beam_size: int = 5,
                              length_penalty: float = 1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached beam search; token-identical to `beam_search_decode`."""
    _check_serving(model)
    img, ids, logp, done = _beam_start(image_embeds, beam_size, bos_id,
                                       pad_id, max_len)
    caches = model.init_caption_cache(img, max_len)
    for t in range(1, max_len):
        logits, caches = model.decode_caption_step(ids[:, t - 1:t], t - 1,
                                                   caches)
        ids, logp, done, beam = _beam_step(logits, ids, logp, done, t,
                                           beam_size, eos_id, pad_id)
        caches = _reorder(caches, beam)
    return _best_beam(ids, logp, beam_size, pad_id, length_penalty)


@torch.inference_mode()
def caption_images(model: FiberCoarse, images, bos_id: int, eos_id: int,
                   pad_id: int, max_len: int = 20, beam_size: int = 5,
                   use_cache: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode the images (B, S, S, 3) NHWC once, then beam-decode them:
    (ids (B, max_len), scores (B,)), on the model's device."""
    _check_serving(model)
    img = torch.as_tensor(images).to(model.device, model.compute_dtype)
    image_embeds = model.encode_image_caption(img)
    decode = beam_search_decode_cached if use_cache else beam_search_decode
    return decode(model, image_embeds, bos_id, eos_id, pad_id, max_len,
                  beam_size)


# ---------------------------------------------------------------------------
# Caption finetuning losses
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _mode(model: FiberCoarse, train: bool):
    """The model with dropout and drop-path on (`train`) or off, restored
    after."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def _caption_logits(model: FiberCoarse, ids: torch.Tensor,
                    masks: torch.Tensor, image_embeds: torch.Tensor
                    ) -> torch.Tensor:
    out = model.infer_caption(ids, masks, image_embeds)
    return model.mlm_logits(out["text_feats"])


def compute_caption_gold(model: FiberCoarse, gold_model: FiberCoarse, batch,
                         pad_id: int, min_prob: float = 0.1,
                         train: bool = True) -> Dict[str, torch.Tensor]:
    """Next-token cross-entropy weighted by a frozen copy of the model
    ("gold"): with `train` each token's weight is max(the gold copy's mean
    probability of the caption's rest x its probability of the token,
    min_prob), detached, and each caption's sum is divided by its PAD
    count; without, the plain mean over every position.

    The student runs with dropout and drop-path iff `train`; the gold copy
    (the caller's `FiberCoarse`, refreshed from the student's state) runs
    without them and without autograd."""
    ids, masks = batch["text_ids"], batch["text_masks"]
    with _mode(model, train), model.autocast():
        img_emb = model.encode_image_caption(batch["image"])
        logits = _caption_logits(model, ids, masks, img_emb)
    labels = shift_labels(ids, pad_id)
    pad_mask = labels == pad_id
    with _fp32(logits.device):
        logits = logits.float()
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, labels[..., None])[..., 0]
        if not train:
            loss = nll.mean()
        else:
            with torch.no_grad(), _mode(gold_model, False), \
                    gold_model.autocast():
                g_emb = gold_model.encode_image_caption(batch["image"])
                g_logits = _caption_logits(gold_model, ids, masks, g_emb)
            g_probs = torch.softmax(g_logits.float(), dim=-1).gather(
                -1, labels[..., None])[..., 0].masked_fill(pad_mask, 0.0)
            valid = (~pad_mask).float()
            # the mean gold probability of each suffix
            rev_sum = torch.cumsum(g_probs.flip(1), dim=1)
            rev_len = torch.cumsum(valid.flip(1), dim=1)
            cum_prob = (rev_sum / rev_len.clamp(min=1.0)).flip(1)
            weights = (cum_prob * g_probs).clamp(min=min_prob).detach()
            per_seq = (weights * nll.masked_fill(pad_mask, 0.0)).sum(-1)
            loss = (per_seq / (pad_mask.sum(-1) + 1e-9)).mean()
        valid = ~pad_mask
        acc = ((valid & (logits.argmax(-1) == labels)).sum()
               / valid.sum().clamp(min=1))
    return {"caption_gold_loss": loss, "caption_gold_accuracy": acc}


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U uniform in (0, 1), as
    `jax.random.gumbel` draws it (its U from [tiny, 1))."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


def _sample_step(logits: torch.Tensor, noise: torch.Tensor, ids: torch.Tensor,
                 done: torch.Tensor, t: int, eos_id: int, pad_id: int,
                 mask_token_id: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token t of every sequence, drawn from softmax(logits) by Gumbel-max
    (argmax of noise + logits, `jax.random.categorical`'s draw on the same
    noise), the mask token's logit set to -10000, PAD once finished.  A
    sequence is finished after EOS or PAD.  Returns new (ids, done); the
    inputs are left as they are."""
    logits = logits.float()
    if mask_token_id >= 0:
        logits = logits.clone()
        logits[:, mask_token_id] = -10000.0
    nxt = (noise + logits).argmax(-1)
    nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
    ids = ids.clone()
    ids[:, t] = nxt
    return ids, done | (nxt == eos_id) | (nxt == pad_id)


def sample_decode(model: FiberCoarse, image_embeds: torch.Tensor,
                  generator: Optional[torch.Generator], bos_id: int,
                  eos_id: int, pad_id: int, max_len: int,
                  num_samples: int = 5, mask_token_id: int = -1,
                  noise: Optional[Callable[[int], torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Multinomial rollouts for SCST: (B num_samples, max_len) token ids,
    the samples of an image next to each other.  A fixed max_len - 1 steps,
    the whole prefix re-encoded each step, no host sync per token, without
    dropout and without autograd.  `noise(t)` gives step t's
    (B num_samples, V) Gumbel noise; by default it is drawn from
    `generator` on the embeddings' device."""
    B, K = image_embeds.shape[0], num_samples
    img = image_embeds.repeat_interleave(K, dim=0)
    ids, done = _start(B * K, max_len, bos_id, pad_id, img.device)
    with torch.no_grad(), _mode(model, False), model.autocast():
        for t in range(1, max_len):
            logits = _step_logits(model, ids, img, pad_id, t - 1).float()
            g = (noise(t) if noise is not None else
                 gumbel_noise(logits.shape, generator, logits.device))
            ids, done = _sample_step(logits, g, ids, done, t, eos_id, pad_id,
                                     mask_token_id)
    return ids


def scst_loss(model: FiberCoarse, images: torch.Tensor,
              sampled_ids: torch.Tensor, rewards: torch.Tensor,
              gt_ids: torch.Tensor, gt_masks: torch.Tensor, pad_id: int,
              alpha: float = 0.3) -> torch.Tensor:
    """alpha MLE(ground truth) + (1 - alpha) policy gradient with CIDEr-D
    rewards: each sampled caption's mean log-probability over its non-PAD
    labels, times (100 - 10 reward), summed over the B num_samples
    captions and divided by the B images.  `rewards` (B num_samples,) in
    [0, 10].  Every forward runs without dropout, with autograd."""
    B = images.shape[0]
    K = sampled_ids.shape[0] // B
    with _mode(model, False), model.autocast():
        img_emb = model.encode_image_caption(images)
        logits = _caption_logits(model, sampled_ids,
                                 (sampled_ids != pad_id).long(),
                                 img_emb.repeat_interleave(K, dim=0))
        gt_logits = _caption_logits(model, gt_ids, gt_masks, img_emb)
    labels = shift_labels(sampled_ids, pad_id)
    pad_mask = labels == pad_id
    with _fp32(logits.device):
        logp = torch.log(torch.softmax(logits.float(), dim=-1) + 1e-9)
        tok_logp = logp.gather(-1, labels[..., None])[..., 0]
        tok_logp = tok_logp.masked_fill(pad_mask, 0.0)
        lens = (~pad_mask).float().sum(-1)
        seq_logp = tok_logp.sum(-1) / (lens + 1e-9)
        rl = (seq_logp * (100.0 - 10.0 * rewards.float())).sum() / B
        gt_labels = shift_labels(gt_ids, pad_id)
        gt_labels = gt_labels.masked_fill(gt_labels == pad_id, IGNORE_INDEX)
        mle, _ = cross_entropy_ignore(gt_logits, gt_labels)
    return alpha * mle + (1.0 - alpha) * rl


def compute_caption_cider(model: FiberCoarse, batch, scorer,
                          detokenize: Callable[[np.ndarray], List[int]],
                          generator: Optional[torch.Generator], *,
                          bos_id: int, eos_id: int, pad_id: int,
                          max_len: int = 50, num_samples: int = 5,
                          alpha: float = 0.3, mask_token_id: int = -1,
                          noise: Optional[Callable[[int], torch.Tensor]] = None
                          ) -> Dict[str, object]:
    """One SCST step's loss: encode, `sample_decode`, one read-back of the
    sampled ids, `detokenize(row) -> token list` on the host, the CIDEr-D
    rewards of `scorer` (a `fiber_torch.native.CiderD` over references
    keyed by sampled row), then `scst_loss`.  Returns the loss (a device
    tensor) and the mean reward (a float)."""
    images = batch["image"]
    with torch.no_grad(), _mode(model, False), model.autocast():
        img_emb = model.encode_image_caption(images)
    sampled = sample_decode(model, img_emb, generator, bos_id, eos_id, pad_id,
                            max_len, num_samples, mask_token_id, noise)
    sampled_np = sampled.cpu().numpy()
    scores = scorer.score({i: detokenize(row)
                           for i, row in enumerate(sampled_np)})
    rewards = np.asarray([scores[i] for i in range(len(sampled_np))],
                         np.float32)
    loss = scst_loss(model, images, sampled,
                     torch.from_numpy(rewards).to(sampled.device),
                     batch["text_ids"], batch["text_masks"], pad_id, alpha)
    return {"caption_cider_loss": loss, "mean_reward": float(rewards.mean())}
