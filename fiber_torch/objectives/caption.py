"""Caption generation: greedy and beam-search decoding, the captioning
serving entry point.

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
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from fiber_torch.models.fiber import FiberCoarse
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
