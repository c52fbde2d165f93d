"""VQA / NLVR2 data plumbing: answer normalization, dense targets,
submission writers.

Behavioral spec: fiber/utils/glossary.py (answer normalization),
fiber/datasets/vqav2_dataset.py:24-47 (label/score lists -> targets),
objectives.py:513-556 (vqa_test_step/wrapup submission jsons).

The normalizer reproduces the official VQA eval protocol (also what the
reference's glossary implements): lowercase, strip punctuation except
in-number commas/apostrophes, digit-word mapping, article removal, and
contraction repair.

The port's copy of `fiber_tpu/data/vqa.py` (pure Python and numpy).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_ARTICLES = {"a", "an", "the"}
_DIGITS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
# common missing-apostrophe repairs from the VQA protocol
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hes": "he's", "im": "i'm",
    "isnt": "isn't", "its": "it's", "ive": "i've", "lets": "let's",
    "maam": "ma'am", "mightve": "might've", "mustve": "must've",
    "shant": "shan't", "shed": "she'd", "shes": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't",
    "somebodyd": "somebody'd", "somebodys": "somebody's",
    "someoned": "someone'd", "someones": "someone's",
    "somethingd": "something'd", "somethings": "something's",
    "thats": "that's", "thered": "there'd", "theres": "there's",
    "theyd": "they'd", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "wasnt": "wasn't", "wed": "we'd",
    "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "yall": "y'all",
    "youd": "you'd", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
_PUNCT = re.compile(r"[;/\[\]\"{}()=+\\_\-><@`?,!.]")
_PERIOD_STRIP = re.compile(r"(?<!\d)\.(?!\d)")
_COMMA_IN_NUM = re.compile(r"(\d),(\d)")


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _COMMA_IN_NUM.sub(r"\1\2", ans)
    ans = _PERIOD_STRIP.sub("", ans)
    ans = _PUNCT.sub(" ", ans)
    words = []
    for w in ans.split():
        w = _DIGITS.get(w, w)
        if w in _ARTICLES:
            continue
        w = _CONTRACTIONS.get(w, w)
        words.append(w)
    return " ".join(words)


def vqa_soft_score(count: int) -> float:
    """Official VQA accuracy of an answer given by `count` of 10
    annotators: min(1, count/3) (used when building label scores)."""
    return min(1.0, count / 3.0)


def build_answer_vocab(annotations: Iterable[Sequence[str]],
                       size: int = 3129) -> Dict[str, int]:
    """Most-common normalized answers -> label ids (ref write_vqa.py)."""
    from collections import Counter
    counts = Counter()
    for answers in annotations:
        for a in answers:
            counts[normalize_answer(a)] += 1
    return {a: i for i, (a, _) in enumerate(counts.most_common(size))}


def dense_vqa_targets(labels: Sequence[Sequence[int]],
                      scores: Sequence[Sequence[float]],
                      num_answers: int) -> np.ndarray:
    """Sparse per-sample (label, score) lists -> dense (B, num_answers)
    (ref objectives.py:185-192)."""
    out = np.zeros((len(labels), num_answers), np.float32)
    for i, (ls, ss) in enumerate(zip(labels, scores)):
        for l, s in zip(ls, ss):
            out[i, l] = s
    return out


def write_vqa_submission(question_ids: Sequence[int],
                         answers: Sequence[str], path: str) -> None:
    """(ref vqa_test_wrapup, objectives.py:538-556)"""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump([{"question_id": int(q), "answer": a}
                   for q, a in zip(question_ids, answers)], f)


def write_caption_submission(image_ids: Sequence[int],
                             captions: Sequence[str], path: str) -> None:
    """(ref caption_test_wrapup, objectives.py:647-679; dedup by id)"""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    seen = {}
    for i, c in zip(image_ids, captions):
        seen[int(i)] = c
    with open(path, "w") as f:
        json.dump([{"image_id": i, "caption": c}
                   for i, c in sorted(seen.items())], f)
