"""Image-text retrieval: ITC ranking + ITM reranking, the serving entry point.

The PyTorch counterpart of `fiber_tpu/objectives/retrieval.py`.  The ITM
rerank runs the fused encoder on (image, text) candidate pairs packed into
batches.  `rank_pairs_pipeline` is the cached path: per-image trunks and
per-text prefixes are encoded once and only the fused tail runs per pair.
`_rank_pairs_full` runs the full forward per pair and is its oracle.

Each loop over chunks stays on the device: the corpus and the pair
indices are moved there once, every chunk is gathered with device index
tensors, and the scores stay on the device until the loop ends, so no
chunk waits on the host.  Every entry point runs under `torch.inference_mode()` and needs
the model in eval mode.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.utils.profiling import span


def _check_serving(model: FiberCoarse) -> None:
    """Serving (retrieval, captioning) runs the model in eval mode."""
    if model.training:
        raise ValueError("serving runs the model in eval mode: call "
                         "model.eval() first")


def _as_device(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _chunks(pair_img: torch.Tensor, pair_txt: torch.Tensor, pair_batch: int):
    n = pair_img.shape[0]
    if n % pair_batch:
        raise ValueError(f"{n} pairs is not a multiple of pair_batch "
                         f"{pair_batch}: pad the index arrays")
    return zip(pair_img.view(-1, pair_batch), pair_txt.view(-1, pair_batch))


@torch.inference_mode()
def _rank_pairs_full(model: FiberCoarse, images, text_ids, text_masks,
                     pair_img, pair_txt, pair_batch: int) -> torch.Tensor:
    """Score candidate pairs with the full fused forward per chunk: the
    oracle of the cached path (the JAX package's `_rank_pairs_scan`).
    pair_img / pair_txt: (n_chunks * pair_batch,) index arrays.  Returns
    (n,) fp32 scores on the device."""
    _check_serving(model)
    dev = model.device
    images = _as_device(images, dev, model.compute_dtype)
    text_ids, text_masks = _as_device(text_ids, dev), _as_device(text_masks, dev)
    pair_img, pair_txt = _as_device(pair_img, dev), _as_device(pair_txt, dev)
    scores = []
    for ci, ct in _chunks(pair_img, pair_txt, pair_batch):
        out = model.infer(images[ci], text_ids[ct], text_masks[ct])
        scores.append(model.rank_scores(out["cls_feats"])[:, 0].float())
    return torch.cat(scores)


@torch.inference_mode()
def encode_trunks(model: FiberCoarse, images, batch: int) -> torch.Tensor:
    """Image trunks for the whole corpus: (N, S, S, 3) -> (N, H3, W3, C3),
    `batch` images at a time (the JAX package's `_encode_trunks_scan`)."""
    _check_serving(model)
    images = _as_device(images, model.device, model.compute_dtype)
    N = images.shape[0]
    if N % batch:
        raise ValueError(f"{N} images is not a multiple of batch {batch}")
    return torch.cat([model.encode_image_trunk(images[i:i + batch])
                      for i in range(0, N, batch)])


@torch.inference_mode()
def _rank_pairs_cached(model: FiberCoarse, trunks: torch.Tensor,
                       text_pre: torch.Tensor, text_masks: torch.Tensor,
                       pair_img, pair_txt, pair_batch: int) -> torch.Tensor:
    """Score candidate pairs from cached per-image trunks and per-text
    prefixes: only the fused tail (the last stage-3 blocks, stage 4 and the
    heads) runs per pair.  Equal to `_rank_pairs_full` by construction."""
    _check_serving(model)
    dev = model.device
    pair_img, pair_txt = _as_device(pair_img, dev), _as_device(pair_txt, dev)
    scores = []
    for ci, ct in _chunks(pair_img, pair_txt, pair_batch):
        out = model.infer_fused_tail(trunks[ci], text_pre[ct], text_masks[ct])
        scores.append(model.rank_scores(out["cls_feats"])[:, 0].float())
    return torch.cat(scores)


@torch.inference_mode()
def rank_pairs_pipeline(model: FiberCoarse, images, text_ids, text_masks,
                        pair_img, pair_txt, pair_batch: int,
                        trunk_batch: int = 8) -> torch.Tensor:
    """End-to-end cached rerank: encode trunks + text prefixes, then score
    all pairs from the caches.  Returns (n_pairs,) fp32 scores on the
    model's device.  In a profiler's trace a call is the span
    `rerank.call`, holding `rerank.trunks`, `rerank.text` and
    `rerank.pairs`."""
    with span("rerank.call"):
        _check_serving(model)
        dev = model.device
        text_ids = _as_device(text_ids, dev)
        text_masks = _as_device(text_masks, dev)
        with span("rerank.trunks"):
            trunks = encode_trunks(model, images, trunk_batch)
        with span("rerank.text"):
            text_pre = model.encode_text_pre(text_ids, text_masks)
        with span("rerank.pairs"):
            return _rank_pairs_cached(model, trunks, text_pre, text_masks,
                                      pair_img, pair_txt, pair_batch)


@torch.inference_mode()
def encode_corpus(model: FiberCoarse, images: np.ndarray,
                  text_ids: np.ndarray, text_masks: np.ndarray,
                  batch_size: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Unfused tower embeddings (normalized) for all images and texts."""
    _check_serving(model)
    dev = model.device
    imgs = _as_device(images, dev, model.compute_dtype)
    img_emb = torch.cat([model.encode_image_itc(imgs[i:i + batch_size])
                         ["cls_feats"] for i in range(0, imgs.shape[0],
                                                      batch_size)])
    txt_emb = model.encode_text_itc(_as_device(text_ids, dev),
                                    _as_device(text_masks, dev))["cls_feats"]
    return img_emb.float().cpu().numpy(), txt_emb.float().cpu().numpy()


def itc_score_matrix(img_emb: np.ndarray, txt_emb: np.ndarray) -> np.ndarray:
    """(Ni, Nt) cosine scores (embeddings already normalized)."""
    return img_emb @ txt_emb.T


def itm_rerank_matrix(model: FiberCoarse, images: np.ndarray,
                      text_ids: np.ndarray, text_masks: np.ndarray,
                      itc_i2t: np.ndarray, rerank_topk: Optional[int] = 32,
                      pair_batch: int = 64,
                      on_device: bool = True) -> np.ndarray:
    """Rerank: fused forward + rank head on the ITC top-k (image, text)
    pairs of every image.

    With on_device=True the cached pipeline runs (rank_pairs_pipeline);
    on_device=False scores pair batches with the full forward, staging
    each batch from the host, for a corpus whose trunks do not fit on the
    device.  Returns the (Ni, Nt) rank scores at the evaluated pairs and
    -inf elsewhere."""
    Ni, Nt = itc_i2t.shape
    k = Nt if rerank_topk is None else min(rerank_topk, Nt)
    top_txt = np.argsort(-itc_i2t, axis=1)[:, :k]        # (Ni, k)
    pair_img = np.repeat(np.arange(Ni), k)
    pair_txt = top_txt.reshape(-1)
    n_pairs = len(pair_img)
    scores = np.full((Ni, Nt), -np.inf, np.float32)

    pad = (-n_pairs) % pair_batch
    pi = np.concatenate([pair_img, np.zeros(pad, np.int64)])
    pt = np.concatenate([pair_txt, np.zeros(pad, np.int64)])
    if on_device:
        trunk_batch = min(8, Ni)
        while Ni % trunk_batch:
            trunk_batch -= 1
        s = rank_pairs_pipeline(model, images, text_ids, text_masks, pi, pt,
                                pair_batch, trunk_batch=trunk_batch)
        scores[pair_img, pair_txt] = s.cpu().numpy()[:n_pairs]
        return scores

    for i in range(0, len(pi), pair_batch):
        bi, bt = pi[i:i + pair_batch], pt[i:i + pair_batch]
        s = _rank_pairs_full(model, images[bi], text_ids[bt], text_masks[bt],
                             np.arange(pair_batch), np.arange(pair_batch),
                             pair_batch)
        n = min(pair_batch, n_pairs - i)
        scores[bi[:n], bt[:n]] = s.cpu().numpy()[:n]
    return scores


def recall_at_k(score_i2t: np.ndarray, img2txt: Sequence[Sequence[int]],
                txt2img: Sequence[int],
                ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """TR@k: rank texts per image (any ground-truth caption in the top k);
    IR@k: rank images per text."""
    Ni, Nt = score_i2t.shape
    out = {}
    order_t = np.argsort(-score_i2t, axis=1)
    for k in ks:
        hit = sum(1 for i in range(Ni)
                  if set(order_t[i, :k].tolist()) & set(img2txt[i]))
        out[f"tr_r{k}"] = hit / Ni
    order_i = np.argsort(-score_i2t.T, axis=1)
    for k in ks:
        hit = sum(1 for t in range(Nt) if txt2img[t] in order_i[t, :k])
        out[f"ir_r{k}"] = hit / Nt
    return out


def evaluate_retrieval(model: FiberCoarse, images, text_ids, text_masks,
                       img2txt, txt2img, rerank_topk: Optional[int] = 32,
                       batch_size: int = 64) -> Dict[str, float]:
    """Full pipeline: ITC recall + ITM-reranked recall."""
    img_emb, txt_emb = encode_corpus(model, images, text_ids, text_masks,
                                     batch_size)
    itc = itc_score_matrix(img_emb, txt_emb)
    metrics = {f"itc_{k}": v
               for k, v in recall_at_k(itc, img2txt, txt2img).items()}
    rerank = itm_rerank_matrix(model, images, text_ids, text_masks, itc,
                               rerank_topk, batch_size)
    # fall back to ITC ordering outside the reranked set
    combined = np.where(np.isinf(rerank), itc - 1e4, rerank)
    metrics.update({f"itm_{k}": v for k, v in
                    recall_at_k(combined, img2txt, txt2img).items()})
    return metrics
