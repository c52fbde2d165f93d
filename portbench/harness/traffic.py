"""The general generator of the cells' inputs, driven by a traffic file's
parameters and the run's seed; everything is drawn on the device, in a
few large calls, so that one seed gives the same inputs on both sides.

Images are standard normal draws in the type the program is fed (the
staged, normalised pixels of a real pipeline have that scale).  Texts
follow RoBERTa's layout: <s> (0), ids drawn from [3, vocab), </s> (2), then
<pad> (1), with lengths uniform in the traffic's `text_len` range.  MLM
masks a `mlm_prob` share of each text's inner tokens (at least one) with
<mask> (the vocabulary's last id).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

BOS, PAD, EOS = 0, 1, 2


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def images(gen: torch.Generator, n: int, size: int, dtype, device
           ) -> torch.Tensor:
    """(n, size, size, 3) NHWC."""
    return torch.randn((n, size, size, 3), generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def texts(gen: torch.Generator, n: int, m: Mapping, lengths: Tuple[int, int],
          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, masks), each (n, max_text_len) long."""
    L = m["max_text_len"]
    lo, hi = lengths
    length = torch.randint(lo, hi + 1, (n, 1), generator=gen, device=device)
    ids = torch.randint(3, m["vocab_size"], (n, L), generator=gen,
                        device=device)
    pos = torch.arange(L, device=device)[None]
    ids = torch.where(pos == 0, BOS, ids)
    ids = torch.where(pos == length - 1, EOS, ids)
    masks = (pos < length).long()
    return torch.where(masks.bool(), ids, PAD), masks


def mlm(gen: torch.Generator, ids: torch.Tensor, masks: torch.Tensor,
        m: Mapping, prob: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids with <mask> at the picked tokens, labels: the picked ids, -100
    elsewhere)."""
    inner = (masks == 1) & (ids != BOS) & (ids != EOS)
    pick = (torch.rand(ids.shape, generator=gen, device=ids.device) < prob) & inner
    pick[:, 1] = True                   # every text has one
    return (torch.where(pick, m["vocab_size"] - 1, ids),
            torch.where(pick, ids, -100))


def pretrain_batches(seed: int, m: Mapping, tr: Mapping, dtype, device
                     ) -> list:
    """`tr["batches"]` batches of `tr["batch"]` pairs, every row its own."""
    gen = generator(seed, device)
    out = []
    for _ in range(tr["batches"]):
        B = tr["batch"]
        img = images(gen, B, m["image_size"], dtype, device)
        ids, masks = texts(gen, B, m, tr["text_len"], device)
        ids_mlm, labels = mlm(gen, ids, masks, m, tr["mlm_prob"])
        out.append({"image": img, "text_ids": ids, "text_masks": masks,
                    "text_ids_mlm": ids_mlm, "text_labels_mlm": labels})
    return out


@torch.no_grad()
def fill_queue(seed: int, rings: Dict[str, torch.Tensor], m: Mapping,
               tr: Mapping) -> None:
    """Fill an ITC queue's rings in place, as a queue that earlier steps
    filled holds them: unit-norm features, images, texts."""
    gen = generator(seed, rings["image_feats"].device)
    for k in ("image_feats", "text_feats"):
        r = rings[k]
        r.normal_(generator=gen)
        r.div_(r.norm(dim=-1, keepdim=True))
    rings["image_inputs"].normal_(generator=gen)
    ids, masks = texts(gen, rings["text_inputs"].shape[0], m, tr["text_len"],
                       rings["text_inputs"].device)
    rings["text_inputs"].copy_(ids)
    rings["text_masks"].copy_(masks)


def rerank_corpus(seed: int, m: Mapping, tr: Mapping, dtype, device
                  ) -> Dict[str, torch.Tensor]:
    """The corpus (images, texts) and each call's pairs: call c takes
    images [c n, (c + 1) n) of the corpus (mod its size) and, for each, its
    `candidates` texts drawn without replacement from the corpus."""
    gen = generator(seed, device)
    n_img, n_txt = tr["corpus_images"], tr["corpus_texts"]
    img = images(gen, n_img, m["image_size"], dtype, device)
    ids, masks = texts(gen, n_txt, m, tr["text_len"], device)
    keys = torch.rand((n_img, n_txt), generator=gen, device=device)
    cand = keys.topk(tr["candidates"], dim=1).indices        # (n_img, k)
    return {"images": img, "text_ids": ids, "text_masks": masks,
            "candidates": cand}


def rerank_call(corpus: Mapping[str, torch.Tensor], tr: Mapping, c: int
                ) -> Dict[str, torch.Tensor]:
    """Call c's inputs: its images, the texts of its pairs (one row a
    pair), and the pair indices into them."""
    n, k = tr["images"], tr["candidates"]
    n_img = corpus["images"].shape[0]
    rows = (c * n + torch.arange(n, device=corpus["images"].device)) % n_img
    txt = corpus["candidates"][rows].reshape(-1)               # (n k,)
    return {"images": corpus["images"][rows],
            "text_ids": corpus["text_ids"][txt],
            "text_masks": corpus["text_masks"][txt],
            "pair_img": torch.arange(n, device=rows.device).repeat_interleave(k),
            "pair_txt": torch.arange(n * k, device=rows.device)}


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------
class WordTokenizer:
    """The prompts' tokenizer, an input both sides read: words and
    punctuation, each word's id fixed by its text (a hash into [10,
    vocab)), <s> 0, <pad> 1, </s> 2; RoBERTa-style layout, with offsets.
    The interface of the port's `WhitespaceTokenizer`."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.ids: Dict[str, int] = {}

    def _id(self, word: str) -> int:
        got = self.ids.get(word)
        if got is None:
            h = 2166136261
            for ch in word.encode():
                h = ((h ^ ch) * 16777619) % (1 << 32)
            got = self.ids[word] = 10 + h % (self.vocab_size - 10)
        return got

    def __call__(self, text: str, max_length: int = 256,
                 truncation: bool = True, padding=None,
                 return_offsets_mapping: bool = False):
        import re
        tokens, offsets = [BOS], [(0, 0)]
        for m in re.finditer(r"\w+|[^\w\s]", text):
            if truncation and len(tokens) >= max_length - 1:
                break
            tokens.append(self._id(m.group(0).lower()))
            offsets.append((m.start(), m.end()))
        tokens.append(EOS)
        offsets.append((0, 0))
        mask = [1] * len(tokens)
        if padding == "max_length":
            pad = max_length - len(tokens)
            tokens, mask = tokens + [PAD] * pad, mask + [0] * pad
            offsets = offsets + [(0, 0)] * pad
        out = {"input_ids": tokens, "attention_mask": mask}
        if return_offsets_mapping:
            out["offset_mapping"] = offsets
        return out

    def batch(self, texts, max_length: int = 256):
        import numpy as np
        encs = [self(t, max_length=max_length, padding="max_length")
                for t in texts]
        return {k: np.asarray([e[k] for e in encs], np.int32)
                for k in ("input_ids", "attention_mask")}


def detection_images(seed: int, m: Mapping, tr: Mapping, device):
    """`tr["pool"]` images staged in the bucket as the evaluation tool
    takes them: each of a true size drawn from `tr["sizes"]`, scaled to fit
    the bucket, its pixels standard normal in the top-left corner, zeros
    elsewhere; (images (n, H, W, 3) fp32 numpy, sizes (n, 2) fp32 numpy,
    the scaled (h, w))."""
    import numpy as np
    gen = generator(seed, device)
    H, W = m["image_size"]
    n = tr["pool"]
    pick = torch.randint(0, len(tr["sizes"]), (n,), generator=gen,
                         device=device).tolist()
    imgs = torch.randn((n, H, W, 3), generator=gen, device=device)
    sizes = []
    for i, k in enumerate(pick):
        h0, w0 = tr["sizes"][k]
        s = min(H / h0, W / w0)
        h, w = int(h0 * s), int(w0 * s)
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
        sizes.append((h, w))
    return imgs.cpu().numpy(), np.asarray(sizes, np.float32)
