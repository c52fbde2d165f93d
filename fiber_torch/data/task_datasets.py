"""Per-task dataset wrappers over reference-format .arrow files.

Mirrors the reference's dataset classes (coarse_grained/fiber/datasets/):
each task fixes the arrow shard names per split and the text column, and
`get_suite` retries corrupt samples with a random re-draw exactly like
the reference (base_dataset.py:151-169).  Task specifics:

* CocoKarpathy / F30kKarpathy / ConceptualCaption / SbuCaption /
  VgCaption — (image, caption) pairs (text column "caption";
  coco_caption_karpathy_dataset.py:11-22, f30k...py:8-16,
  conceptual_caption_dataset.py:8-18, sbu...py:10-18, vg...py:9-17)
* VQAv2 — questions + soft answer labels/scores
  (vqav2_dataset.py:24-47)
* NLVR2 — paired images + boolean answer (nlvr2_dataset.py:26-60)

Unlike the torch DataLoader stack, samples come back as plain numpy for
host batching (data/arrow_dataset.py handles the sharded iteration).

The port's copy of `fiber_tpu/data/task_datasets.py`, over the port's
`ArrowCaptionDataset`."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from fiber_torch.data.arrow_dataset import ArrowCaptionDataset

# per-task arrow shard names (reference datasets/*.py)
TASK_NAMES: Dict[str, Dict[str, List[str]]] = {
    "coco": {
        "train": ["coco_caption_karpathy_train", "coco_caption_karpathy_val"],
        "val": ["coco_caption_karpathy_test"],
        "test": ["coco_caption_karpathy_test"],
    },
    "f30k": {
        "train": ["f30k_caption_karpathy_train", "f30k_caption_karpathy_val"],
        "val": ["f30k_caption_karpathy_test"],
        "test": ["f30k_caption_karpathy_test"],
    },
    "gcc": {
        "train": [f"conceptual_caption_train_{i}" for i in range(31)],
        "val": [],
        "test": [],
    },
    "sbu": {
        "train": [f"sbu_{i}" for i in range(9)],
        "val": [],
        "test": [],
    },
    "vg": {
        "train": ["vg"],
        "val": [],
        "test": [],
    },
    "vqav2": {
        "train": ["vqav2_train", "vqav2_val"],
        "val": ["vqav2_val"],
        "test": ["vqav2_test"],
    },
    "nlvr2": {
        "train": ["nlvr2_train"],
        "val": ["nlvr2_dev", "nlvr2_test1"],
        "test": ["nlvr2_dev", "nlvr2_test1"],
    },
}

TEXT_COLUMNS = {
    "coco": "caption", "f30k": "caption", "gcc": "caption",
    "sbu": "caption", "vg": "caption",
    "vqav2": "questions", "nlvr2": "questions",
}


def arrow_paths(root: str, task: str, split: str) -> List[str]:
    """Shard paths for a task/split; [] when the reference defines no
    shards for that split (gcc/sbu/vg have train only)."""
    names = TASK_NAMES[task][split]
    paths = [os.path.join(root, f"{n}.arrow") for n in names]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"{task}/{split}: missing arrow shards {missing}")
    return paths


class TaskDataset:
    """Caption-style task dataset with corrupt-sample retry and ITM
    false-image/false-text draws (ref base_dataset.py:102-169)."""

    task: str = "coco"

    def __init__(self, root: str, split: str, image_size: int = 384,
                 train: Optional[bool] = None,
                 draw_false_image: int = 0, draw_false_text: int = 0,
                 image_only: bool = False, seed: int = 0,
                 max_retries: int = 50):
        assert split in ("train", "val", "test")
        self.split = split
        self.train = train if train is not None else (split == "train")
        self.image_size = image_size
        self.draw_false_image = draw_false_image
        self.draw_false_text = draw_false_text
        self.image_only = image_only
        self.max_retries = max_retries
        self.rng = np.random.default_rng(seed)
        paths = arrow_paths(root, self.task, split)
        # empty split (e.g. gcc/sbu/vg val): an empty dataset, like the
        # reference's len(names)==0 handling (base_dataset.py:30-46)
        self.ds = (ArrowCaptionDataset(
            paths, caption_column=TEXT_COLUMNS[self.task])
            if paths else None)

    def __len__(self) -> int:
        return 0 if self.ds is None else len(self.ds)

    # -- per-sample pieces (override in task subclasses) --------------
    def _sample(self, i: int) -> Dict[str, Any]:
        ret: Dict[str, Any] = {
            "image": self.ds.get_image(i, self.image_size,
                                       train=self.train, rng=self.rng),
            "raw_index": i,
        }
        if not self.image_only:
            ret["text"] = self.ds.get_caption(i)
            ret["cap_index"] = self.ds.index[i][1]
        for rep in range(self.draw_false_image):
            j = int(self.rng.integers(len(self.ds)))
            ret[f"false_image_{rep}"] = self.ds.get_image(
                j, self.image_size, train=self.train, rng=self.rng)
        for rep in range(self.draw_false_text):
            j = int(self.rng.integers(len(self.ds)))
            ret[f"false_text_{rep}"] = self.ds.get_caption(j)
        return ret

    def get_suite(self, i: int) -> Dict[str, Any]:
        """Fetch sample i; on a corrupt record, re-draw a random index
        (ref base_dataset.py:151-169 `while result is None`)."""
        if self.ds is None:
            raise IndexError(f"{self.task}/{self.split} is an empty split")
        for _ in range(self.max_retries):
            try:
                return self._sample(i)
            except Exception:
                i = int(self.rng.integers(len(self.ds)))
        raise RuntimeError(
            f"{self.task}: {self.max_retries} consecutive corrupt samples")

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.get_suite(i)


class CocoKarpathyDataset(TaskDataset):
    task = "coco"


class F30kKarpathyDataset(TaskDataset):
    task = "f30k"


class ConceptualCaptionDataset(TaskDataset):
    task = "gcc"


class SbuCaptionDataset(TaskDataset):
    task = "sbu"


class VgCaptionDataset(TaskDataset):
    task = "vg"


class VQAv2Dataset(TaskDataset):
    """Adds question id + soft answers (vqav2_dataset.py:24-47)."""

    task = "vqav2"

    def _sample(self, i: int) -> Dict[str, Any]:
        ret = super()._sample(i)
        row, qi = self.ds.index[i]
        tbl = self.ds.table
        ret["qid"] = tbl["question_id"][row][qi].as_py()
        if self.split != "test":
            ret["vqa_answer"] = tbl["answers"][row][qi].as_py()
            ret["vqa_labels"] = tbl["answer_labels"][row][qi].as_py()
            ret["vqa_scores"] = tbl["answer_scores"][row][qi].as_py()
        else:
            ret["vqa_answer"] = []
            ret["vqa_labels"] = []
            ret["vqa_scores"] = []
        return ret


class NLVR2Dataset(TaskDataset):
    """Paired images + True/False answer (nlvr2_dataset.py:26-60)."""

    task = "nlvr2"

    def _sample(self, i: int) -> Dict[str, Any]:
        row, qi = self.ds.index[i]
        img0 = ArrowCaptionDataset.get_image(
            _aliased(self.ds, "image_0"), i, self.image_size,
            train=self.train, rng=self.rng)
        img1 = ArrowCaptionDataset.get_image(
            _aliased(self.ds, "image_1"), i, self.image_size,
            train=self.train, rng=self.rng)
        ans = self.ds.table["answers"][row][qi].as_py()
        return {
            "image_0": img0, "image_1": img1,
            "text": self.ds.get_caption(i),
            "answers": bool(ans == "True" or ans is True),
            "raw_index": i,
        }


class _aliased:
    """View of an ArrowCaptionDataset reading a different image column."""

    def __init__(self, ds: ArrowCaptionDataset, column: str):
        self.table = ds.table
        self.index = ds.index
        self.image_column = column


TASK_DATASETS = {
    "coco": CocoKarpathyDataset, "f30k": F30kKarpathyDataset,
    "gcc": ConceptualCaptionDataset, "sbu": SbuCaptionDataset,
    "vg": VgCaptionDataset, "vqav2": VQAv2Dataset, "nlvr2": NLVR2Dataset,
}


def build_task_dataset(task: str, root: str, split: str,
                       **kwargs) -> TaskDataset:
    if task not in TASK_DATASETS:
        raise KeyError(f"unknown task {task!r}; known: {sorted(TASK_DATASETS)}")
    return TASK_DATASETS[task](root, split, **kwargs)
