"""Epoch metric accumulation and the checkpoint-selection scalar.

The port's copy of `fiber_tpu/train/metrics.py` (numpy only; the port
cannot import that package).  Per-task weighted means of the step metrics;
`the_metric` sums each active task's epoch accuracy or score (VQA score,
ITM / NLVR2 / MLM / caption accuracy) plus IR@1 + TR@1 when retrieval
recall is given, as the reference's epoch wrap-up does.

A step metric may be a 0-dim tensor, as `CoarseTrainer` returns them: it
is read once, at `update`.

`check_expected_results` is the port's copy of the EXPECTED_RESULTS check
of `fiber_tpu/detection/evaluation.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class MeanAccumulator:
    """Weighted running mean; non-finite values are skipped."""

    def __init__(self):
        self.total = 0.0
        self.count = 0.0

    def update(self, value: float, weight: float = 1.0):
        if np.isfinite(value):
            self.total += float(value) * weight
            self.count += weight

    def compute(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def reset(self):
        self.total = 0.0
        self.count = 0.0


class EpochMetrics:
    """Accumulates per-step metric dicts and composes `the_metric`."""

    # which per-task statistic contributes to the_metric
    _KEY_FOR_TASK = {
        "vqa": "vqa_score",
        "nlvr2": "nlvr2_accuracy",
        "itm": "itm_accuracy",
        "mlm": "mlm_accuracy",
        "caption_mle": "caption_mle_accuracy",
        "caption_gold": "caption_gold_accuracy",
        "caption_cider": "caption_cider_accuracy",
    }

    def __init__(self, loss_names):
        self.loss_names = tuple(loss_names)
        self.acc: Dict[str, MeanAccumulator] = {}

    def update(self, step_metrics: Dict[str, object], weight: float = 1.0):
        for k, v in step_metrics.items():
            self.acc.setdefault(k, MeanAccumulator()).update(
                float(v.item() if hasattr(v, "item") else v), weight)

    def compute(self, recall_metrics: Optional[Dict[str, float]] = None
                ) -> Dict[str, float]:
        out = {k: a.compute() for k, a in self.acc.items()}
        the_metric = 0.0
        for task in self.loss_names:
            key = self._KEY_FOR_TASK.get(task)
            if key and key in out and np.isfinite(out[key]):
                the_metric += out[key]
        if recall_metrics:
            out.update(recall_metrics)
            the_metric += recall_metrics.get("itc_ir_r1", 0.0)
            the_metric += recall_metrics.get("itc_tr_r1", 0.0)
        out["the_metric"] = the_metric
        return out

    def reset(self):
        for a in self.acc.values():
            a.reset()


def check_expected_results(metrics: Dict[str, float],
                           expected: Sequence[Tuple[str, float, float]]
                           ) -> List[str]:
    """EXPECTED_RESULTS regression assert (ref coco_eval.py:42-70):
    each entry (metric, mean, tol); returns list of violation messages."""
    errors = []
    for name, mean, tol in expected:
        actual = metrics.get(name)
        if actual is None:
            errors.append(f"missing metric {name}")
        elif not (mean - tol <= actual <= mean + tol):
            errors.append(
                f"{name}={actual:.4f} outside {mean:.4f}+-{tol:.4f}")
    return errors
