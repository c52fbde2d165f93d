"""Few-shot detection finetuning: tuning modes, X-shot subsets, early stop.

The PyTorch counterpart of `fiber_tpu/train/finetune.py`:

* the tuning modes of the reference's `tuning_highlevel_override`: "full"
  trains everything, "linear_prob" only the prediction heads, the
  "language_prompt_v*" modes freeze the backbone, FPN and head and train
  the language backbone and / or the zero-initialised prompt
  `tunable_linear`;
* `x_shot_subset`: images picked until every class has `shots` instances;
* `EarlyStopper`: patience on a validation metric.

A mode freezes a parameter as the JAX package does: its gradient is zeroed
before the clip and AdamW, so AdamW's decoupled weight decay still moves
it by lr x wd x p a step where its group decays.  The PyTorch FIBER
reference sets `requires_grad=False` instead and leaves it where it is.
The trainer keeps zero gradients on frozen parameters rather than
`requires_grad=False`, which torch's AdamW would skip.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from fiber_torch.utils.convert import detection_flax_path

TUNING_MODES = ("full", "linear_prob", "language_prompt_v1",
                "language_prompt_v2", "language_prompt_v3",
                "language_prompt_v4")

# the flag table of the reference's tuning_highlevel_override
TUNING_FLAGS = {
    #                   backbone fpn   rpn   linear_prob add_linear lang
    "full":              (False, False, False, False, False, False),
    "linear_prob":       (True,  True,  False, True,  False, True),
    "language_prompt_v1": (True, True,  True,  False, False, False),
    "language_prompt_v2": (True, True,  True,  False, True,  True),
    "language_prompt_v3": (True, True,  True,  True,  False, False),
    "language_prompt_v4": (True, True,  True,  True,  True,  True),
}

_LINEAR_PROB_HEADS = ("cls_logits", "bbox_pred", "centerness",
                      "dot_product_projection_text", "bias_lang",
                      "bias0", "log_scale", "scales")


def tuning_highlevel_override(mode: str) -> Dict[str, bool]:
    """{flag: frozen / enabled} of a tuning mode."""
    b, f, r, lp, al, lang = TUNING_FLAGS[mode]
    return {"backbone_freeze": b, "fpn_freeze": f, "rpn_freeze": r,
            "linear_prob": lp, "add_linear_layer": al,
            "language_backbone_freeze": lang}


def is_trainable(name: str, mode: str, use_deform: bool = True) -> bool:
    """Whether the port detector's parameter `name` trains under `mode`:
    the JAX package's rule on its flax path.  The regions: the prompt
    `tunable_linear`, the language backbone, the FPN, the Swin trunk
    (patch embed, stages and the output norms), and the rest, the head."""
    if mode == "full":
        return True
    flags = tuning_highlevel_override(mode)
    path = detection_flax_path(name, use_deform)
    if "tunable_linear" in path:
        return flags["add_linear_layer"]
    if "language_backbone" in path:
        return not flags["language_backbone_freeze"]
    if "fpn" in path:
        return not flags["fpn_freeze"]
    if any(s in path for s in ("patch_embed", "layers_", "out_norm")):
        return not flags["backbone_freeze"]
    if flags["linear_prob"]:
        return any(h in path for h in _LINEAR_PROB_HEADS)
    return not flags["rpn_freeze"]


def trainable_mask(model, mode: str) -> Dict[str, bool]:
    """{parameter name: trains under `mode`} over the port detector's
    parameters."""
    return {name: is_trainable(name, mode, model.cfg.use_deform)
            for name, _ in model.named_parameters()}


def apply_tuning_mode(trainer, mode: str) -> None:
    """Freeze the parameters `mode` does not train: the trainer zeroes
    their gradients each step before the clip and AdamW."""
    mask = trainable_mask(trainer.model, mode)
    trainer.frozen = [p for name, p in trainer.model.named_parameters()
                      if not mask[name]]


def x_shot_subset(image_labels: Sequence[Sequence[int]], shots: int,
                  rng: Optional[np.random.Generator] = None) -> List[int]:
    """Image indices, picked in a random order until every class present
    has at least `shots` instances; sorted."""
    rng = rng or np.random.default_rng(0)
    order = rng.permutation(len(image_labels))
    counts: Dict[int, int] = {}
    all_classes = {c for labels in image_labels for c in labels}
    chosen: List[int] = []
    for i in order:
        labels = image_labels[i]
        if not labels:
            continue
        if any(counts.get(c, 0) < shots for c in labels):
            chosen.append(int(i))
            for c in labels:
                counts[c] = counts.get(c, 0) + 1
        if all(counts.get(c, 0) >= shots for c in all_classes):
            break
    return sorted(chosen)


class EarlyStopper:
    """Patience-based early termination on a validation metric."""

    def __init__(self, patience: int = 8, minimize: bool = False):
        self.patience, self.minimize = patience, minimize
        self.best: Optional[float] = None
        self.bad = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        better = (self.best is None
                  or (value < self.best if self.minimize
                      else value > self.best))
        if better:
            self.best, self.bad = value, 0
        else:
            self.bad += 1
        return self.bad >= self.patience
