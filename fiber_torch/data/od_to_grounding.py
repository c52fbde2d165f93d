"""Detection labels -> grounding prompts and token maps (host side, numpy).

The port's copy of `fiber_tpu/data/od_to_grounding.py`:

* a caption "person. bicycle. car." is built from the class names present
  (and sampled negative classes), recording the char span of each class;
* `positive_map` (boxes x T) marks the tokens of each box's class span;
* `positive_map_label_to_token` {label: [token ids]} drives the eval-time
  grounding-to-class score conversion;
* the token budget is checked against the query length
  (`check_for_positive_overflow`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class GroundingPrompt:
    caption: str
    # label -> (char_start, char_end) span inside caption
    label_spans: Dict[int, Tuple[int, int]]


def build_detection_prompt(label_names: Dict[int, str],
                           labels_present: Sequence[int],
                           num_negatives: int = 85,
                           rng: Optional[np.random.Generator] = None,
                           separator: str = ". ",
                           shuffle: bool = True) -> GroundingPrompt:
    """Compose 'name1. name2. ...' with positives + sampled negatives
    (ref convert_object_detection_to_grounding_optimized_for_od,
    od_to_grounding.py:149-333; RANDOM_SAMPLE_NEG=85)."""
    rng = rng or np.random.default_rng()
    positives = sorted(set(int(l) for l in labels_present))
    negatives = [l for l in label_names if l not in positives]
    if len(negatives) > num_negatives:
        negatives = list(rng.choice(negatives, num_negatives,
                                    replace=False))
    chosen = positives + [int(n) for n in negatives]
    if shuffle:
        rng.shuffle(chosen)
    caption = ""
    spans: Dict[int, Tuple[int, int]] = {}
    for i, label in enumerate(chosen):
        name = label_names[label].strip().lower()
        start = len(caption)
        caption += name
        spans[label] = (start, len(caption))
        if i != len(chosen) - 1:
            caption += separator
    return GroundingPrompt(caption=caption, label_spans=spans)


def char_spans_to_token_ids(tokenizer, caption: str,
                            span: Tuple[int, int],
                            max_len: int) -> List[int]:
    """Map a char span to token indices via the tokenizer offsets."""
    enc = tokenizer(caption, return_offsets_mapping=True,
                    max_length=max_len, truncation=True)
    toks = []
    for ti, (s, e) in enumerate(enc["offset_mapping"]):
        if s == e:  # special token
            continue
        if s < span[1] and e > span[0]:
            toks.append(ti)
    return toks


def build_positive_map(tokenizer, caption: str,
                       box_spans: Sequence[Tuple[int, int]],
                       max_len: int) -> np.ndarray:
    """(num_boxes, max_len) 0/1 token matrix (ref create_positive_map,
    modulated_coco.py:630-657)."""
    enc = tokenizer(caption, return_offsets_mapping=True,
                    max_length=max_len, truncation=True)
    offsets = enc["offset_mapping"]
    m = np.zeros((len(box_spans), max_len), np.float32)
    for bi, (s0, s1) in enumerate(box_spans):
        for ti, (s, e) in enumerate(offsets):
            if s == e or ti >= max_len:
                continue
            if s < s1 and e > s0:
                m[bi, ti] = 1.0
    return m


def build_label_to_token_map(tokenizer, prompt: GroundingPrompt,
                             max_len: int) -> Dict[int, List[int]]:
    """{label: [token ids]} for eval-time score aggregation
    (ref create_queries_and_maps, engine/inference.py:156-272)."""
    return {label: char_spans_to_token_ids(tokenizer, prompt.caption,
                                           span, max_len)
            for label, span in prompt.label_spans.items()}


def check_for_positive_overflow(prompt: GroundingPrompt, tokenizer,
                                labels_present: Sequence[int],
                                max_len: int) -> bool:
    """True if every positive class's tokens fit the budget
    (ref od_to_grounding.py:104-147)."""
    l2t = build_label_to_token_map(tokenizer, prompt, max_len)
    return all(len(l2t.get(int(l), [])) > 0 for l in set(labels_present))


def chunk_class_names(label_names: Dict[int, str], chunk_size: int
                      ) -> List[List[int]]:
    """Split a large vocabulary into prompt chunks for chunked evaluation
    (ref TEST.CHUNKED_EVALUATION, engine/inference.py:142-154)."""
    labels = sorted(label_names)
    return [labels[i:i + chunk_size]
            for i in range(0, len(labels), chunk_size)]
