"""Whole-batch MLM masking (numpy, host-side).

The port's copy of `fiber_tpu/data/mlm.py`: the same draws from the same
`np.random.Generator`, so its output equals the JAX package's bit for bit.

Replicates the semantics of HF DataCollatorForLanguageModeling as used by
the reference (ref: datamodule_base.py:85-95, mlm_prob 0.15): of the
selected 15%, 80% -> [MASK], 10% -> random token, 10% -> unchanged; labels
are -100 everywhere else.  Special tokens and padding are never masked.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IGNORE_INDEX = -100


def mlm_mask(ids: np.ndarray, special_mask: np.ndarray, vocab_size: int,
             mask_token_id: int, rng: np.random.Generator,
             mlm_prob: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Return (masked_ids, labels).

    ids:           (B, L) int
    special_mask:  (B, L) bool — True at special/pad positions (never masked)
    """
    ids = np.array(ids, copy=True)
    labels = np.array(ids, copy=True)
    prob = np.full(ids.shape, mlm_prob)
    prob[special_mask] = 0.0
    masked = rng.random(ids.shape) < prob
    labels[~masked] = IGNORE_INDEX

    replace = masked & (rng.random(ids.shape) < 0.8)
    ids[replace] = mask_token_id
    randomize = masked & ~replace & (rng.random(ids.shape) < 0.5)
    ids[randomize] = rng.integers(0, vocab_size, ids.shape)[randomize]
    return ids, labels
