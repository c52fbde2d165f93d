"""Tokenizer plumbing.

Production path: the HF roberta-base tokenizer (what the reference uses,
datamodule_base.py get_pretrained_tokenizer / generalized_vl_rcnn.py
tokenizer), loaded from local cache or from vocab+merges files.

Test/offline path: `WhitespaceTokenizer`, a tiny offset-mapping tokenizer
with roberta-compatible special-token conventions (<s> ... </s>, pad=1),
so positive-map and prompt logic is testable without network access.

The port's copy of `fiber_tpu/data/tokenizer.py`.  Nothing is downloaded:
`load_tokenizer` reads local files only, and `transformers` is imported
inside the functions that need it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np


class WhitespaceTokenizer:
    """Word-level tokenizer with offset mapping and a growable vocab.

    ids: 0=<s>, 1=<pad>, 2=</s>, 3=<unk>, 4=<mask>, words from 10.
    """

    bos_token_id = 0
    pad_token_id = 1
    eos_token_id = 2
    unk_token_id = 3
    mask_token_id = 4

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 frozen: bool = False):
        self.vocab: Dict[str, int] = dict(vocab or {})
        self.frozen = frozen
        self._next = 10 + max(self.vocab.values(), default=-1) + 1 \
            if self.vocab else 10

    @property
    def vocab_size(self) -> int:
        return max(self._next, 10)

    def _id(self, word: str) -> int:
        if word not in self.vocab:
            if self.frozen:
                return self.unk_token_id
            self.vocab[word] = self._next
            self._next += 1
        return self.vocab[word]

    def __call__(self, text: str, max_length: int = 256,
                 truncation: bool = True, padding: Optional[str] = None,
                 return_offsets_mapping: bool = False):
        tokens: List[int] = [self.bos_token_id]
        offsets: List[tuple] = [(0, 0)]
        for m in re.finditer(r"\w+|[^\w\s]", text):
            if truncation and len(tokens) >= max_length - 1:
                break
            tokens.append(self._id(m.group(0).lower()))
            offsets.append((m.start(), m.end()))
        tokens.append(self.eos_token_id)
        offsets.append((0, 0))
        if truncation:
            tokens = tokens[:max_length]
            offsets = offsets[:max_length]
        mask = [1] * len(tokens)
        if padding == "max_length":
            pad = max_length - len(tokens)
            tokens = tokens + [self.pad_token_id] * pad
            offsets = offsets + [(0, 0)] * pad
            mask = mask + [0] * pad
        out = {"input_ids": tokens, "attention_mask": mask}
        if return_offsets_mapping:
            out["offset_mapping"] = offsets
        return out

    def batch(self, texts: Sequence[str], max_length: int = 256):
        encs = [self(t, max_length=max_length, padding="max_length")
                for t in texts]
        return {
            "input_ids": np.asarray([e["input_ids"] for e in encs],
                                    np.int32),
            "attention_mask": np.asarray([e["attention_mask"] for e in encs],
                                         np.int32),
        }


def load_tokenizer(name_or_path: str = "roberta-base"):
    """HF tokenizer when available locally, else raise with guidance."""
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(name_or_path,
                                         local_files_only=True)


def get_tokenizer(spec: Optional[str] = None, warn: bool = True):
    """Production tokenizer resolution for CLIs (ref
    datamodule_base.py:13-19 get_pretrained_tokenizer): try the real HF
    tokenizer (`spec` = name or local path, default roberta-base, local
    files only — this environment has no network), fall back to the
    whitespace tokenizer with a loud warning so smoke runs still work.
    """
    import os
    import warnings
    try:
        if spec and os.path.isdir(spec) and \
                os.path.exists(os.path.join(spec, "vocab.json")) and \
                os.path.exists(os.path.join(spec, "merges.txt")) and \
                not os.path.exists(os.path.join(spec,
                                                "tokenizer_config.json")):
            # bare vocab+merges directory: build the roberta BPE directly
            from transformers import RobertaTokenizerFast
            return RobertaTokenizerFast(
                vocab_file=os.path.join(spec, "vocab.json"),
                merges_file=os.path.join(spec, "merges.txt"))
        return load_tokenizer(spec or "roberta-base")
    except Exception as e:
        if warn:
            warnings.warn(
                f"could not load HF tokenizer ({spec or 'roberta-base'}): "
                f"{type(e).__name__}; falling back to WhitespaceTokenizer. "
                "Pass --tokenizer <path with vocab.json+merges.txt> for "
                "real-BPE tokenization.")
        return WhitespaceTokenizer()
