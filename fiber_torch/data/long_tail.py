"""Long-tail dataset readers behind the catalog names.

Covers the reference dataset classes not already served by
coco_datasets/tsv/task_datasets (SURVEY.md §2.2 "Other datasets"):

* mixed (MDETR mixed COCO+VG grounding)   — ref data/datasets/mixed.py
* gqa (+question answering fields)        — ref data/datasets/gqa.py
* phrasecut                               — ref data/datasets/phrasecut.py
* CaptionTSV with pseudo boxes            — ref data/datasets/caption.py
* background (annotation-free negatives)  — ref data/datasets/background.py
* imagenet (classification pretraining)   — ref data/datasets/imagenet.py
* detection mixup wrapper                 — ref data/datasets/mixup.py

All readers emit the same dict schema as coco_datasets (image HWC uint8/
float, boxes xyxy, labels, input_ids/attention_mask/positive_map for
grounding flavors) so DetectionBatcher consumes them unchanged.

The port's copy of `fiber_tpu/data/long_tail.py`, on the port's readers
(`fiber_torch/data/coco_datasets.py`, `tsv.py`).  PIL is imported only
where an image is decoded.  One difference from JAX, on purpose:
`CaptionPseudoBoxDataset` keeps the zero image for a blob that fails to
decode, but a missing PIL raises ImportError instead of turning every
image black.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from fiber_torch.data.coco_datasets import (ModulatedCocoDataset,
                                            _load_image, _pad_ids,
                                            create_positive_map_from_spans)
from fiber_torch.data.tsv import TsvFile


class MixedGroundingDataset(ModulatedCocoDataset):
    """MDETR "mixed" grounding: one annotation file over images drawn
    from two roots (COCO + Visual Genome), selected per image by its
    `data_source` field (ref mixed.py:58-78)."""

    def __init__(self, root_coco: str, root_vg: str, ann_file: str,
                 tokenizer, max_query_len: int = 256,
                 transform: Optional[Callable] = None):
        super().__init__(root_coco, ann_file, tokenizer,
                         max_query_len=max_query_len, transform=transform)
        self.root_coco = root_coco
        self.root_vg = root_vg

    def __getitem__(self, idx: int) -> dict:
        info = self.images[idx]
        root = (self.root_coco if info.get("data_source") == "coco"
                else self.root_vg)
        prev = self.img_folder
        try:
            self.img_folder = root
            return super().__getitem__(idx)
        finally:
            self.img_folder = prev


class PhrasecutDataset(ModulatedCocoDataset):
    """PhraseCut region descriptions in the modulated format (the
    reference class is literally `ModulatedDataset` subclassed with
    `pass`, phrasecut.py:7-8)."""


class GQAGroundingDataset(ModulatedCocoDataset):
    """GQA grounding in the modulated format; when answer maps are
    given, each item also carries the QA target ids
    (ref gqa.py:14-63 GQAQuestionAnswering)."""

    TYPE2ID = {"obj": 0, "attr": 1, "rel": 2, "global": 3, "cat": 4}

    def __init__(self, img_folder: str, ann_file: str, tokenizer,
                 max_query_len: int = 256,
                 answer2id_file: Optional[str] = None,
                 answer2id_by_type_file: Optional[str] = None,
                 transform: Optional[Callable] = None):
        super().__init__(img_folder, ann_file, tokenizer,
                         max_query_len=max_query_len, transform=transform)
        self.answer2id = (json.load(open(answer2id_file))
                          if answer2id_file else None)
        self.answer2id_by_type = (json.load(open(answer2id_by_type_file))
                                  if answer2id_by_type_file else None)

    def __getitem__(self, idx: int) -> dict:
        rec = super().__getitem__(idx)
        info = self.images[idx]
        if self.answer2id is not None:
            ans = info.get("answer", "unknown")
            if ans not in self.answer2id:
                ans = "unknown"
            rec["answer"] = np.int32(self.answer2id[ans])
            qt = info.get("question_type", "obj")
            rec["answer_type"] = np.int32(self.TYPE2ID.get(qt, 0))
            if self.answer2id_by_type is not None:
                for field, key in (("answer_attr", "attr"),
                                   ("answer_rel", "rel"),
                                   ("answer_global", "global"),
                                   ("answer_cat", "cat")):
                    table = self.answer2id_by_type.get(f"answer_{key}", {})
                    a = info.get("answer", "unknown")
                    if a not in table:
                        a = "unknown"
                    rec[field] = np.int32(
                        table.get(a, 0) if qt == key else -100)
        return rec


def _nms_keep(boxes: np.ndarray, scores: np.ndarray,
              thr: float) -> np.ndarray:
    order = np.argsort(-scores, kind="mergesort")
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        lt = np.maximum(boxes[i, :2], boxes[rest, :2])
        rb = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        a = ((boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
             + (boxes[rest, 2] - boxes[rest, 0])
             * (boxes[rest, 3] - boxes[rest, 1]) - inter)
        order = rest[inter / np.maximum(a, 1e-9) < thr]
    return np.asarray(keep, np.int64)


class CaptionPseudoBoxDataset:
    """Web-caption TSV with teacher pseudo boxes (ref caption.py
    CaptionTSV): each row is (key, json, image); the json carries
    {caption, tokens_positive (per-box span lists), bboxes xyxy, scores,
    img_h, img_w}.  Boxes below `score_thresh` are dropped, NMS at
    `nms_thresh` dedups the teacher boxes, rows with fewer than
    `caption_min_box` surviving boxes raise IndexError so the loader's
    corrupt-retry path resamples (ref caption.py:137-179)."""

    def __init__(self, tsv_path: str, tokenizer,
                 max_query_len: int = 256, caption_min_box: int = 1,
                 score_thresh: float = 0.0,
                 nms_thresh: Optional[float] = None):
        self.tsv = TsvFile(tsv_path)
        self.tokenizer = tokenizer
        self.max_query_len = max_query_len
        self.caption_min_box = caption_min_box
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh

    def __len__(self) -> int:
        return len(self.tsv)

    def __getitem__(self, idx: int) -> dict:
        key, ann_json, img_field = self.tsv.row(idx)[:3]
        anno = json.loads(ann_json)
        boxes = np.asarray(anno.get("bboxes", []), np.float32
                           ).reshape(-1, 4)
        scores = np.asarray(anno.get("scores", [1.0] * len(boxes)),
                            np.float32)
        spans: List[list] = anno.get("tokens_positive",
                                     [[] for _ in boxes])
        if self.score_thresh > 0 and len(boxes):
            keep = scores > self.score_thresh
            boxes, scores = boxes[keep], scores[keep]
            spans = [s for s, k in zip(spans, keep) if k]
        if self.nms_thresh is not None and len(boxes):
            keep = _nms_keep(boxes, scores, self.nms_thresh)
            boxes, scores = boxes[keep], scores[keep]
            spans = [spans[i] for i in keep]
        if len(boxes) < self.caption_min_box:
            raise IndexError(
                f"row {idx}: {len(boxes)} pseudo boxes "
                f"< caption_min_box={self.caption_min_box}")

        caption = anno["caption"]
        enc = self.tokenizer(caption, return_offsets_mapping=True,
                             max_length=self.max_query_len,
                             truncation=True, padding="max_length")
        import base64
        import io

        from PIL import Image   # no PIL: raise, not a black image
        try:
            img = np.asarray(Image.open(
                io.BytesIO(base64.b64decode(img_field))).convert("RGB"))
        except Exception:       # a blob that does not decode
            img = np.zeros((int(anno.get("img_h", 1)),
                            int(anno.get("img_w", 1)), 3), np.uint8)
        return {
            "image_id": key, "image": img,
            "height": int(anno.get("img_h", img.shape[0])),
            "width": int(anno.get("img_w", img.shape[1])),
            "boxes": boxes, "scores": scores,
            "labels": np.ones(len(boxes), np.int32),
            "caption": caption,
            "input_ids": _pad_ids(enc["input_ids"], self.max_query_len),
            "attention_mask": _pad_ids(enc["attention_mask"],
                                       self.max_query_len),
            "positive_map": create_positive_map_from_spans(
                enc["offset_mapping"], spans, self.max_query_len,
                normalize=True),
            "greenlight_span_for_masked_lm_objective":
                [(0, len(caption))],
        }


class BackgroundDataset:
    """Annotation-free negative images (ref background.py): json
    {"images": [{"file_name", ...}]} + an image root; items carry empty
    boxes so they act as pure negatives in detection training."""

    def __init__(self, ann_file: str, root: str,
                 transform: Optional[Callable] = None):
        with open(ann_file) as f:
            self.infos = json.load(f)["images"]
        self.root = root
        self.transform = transform

    def __len__(self) -> int:
        return len(self.infos)

    def __getitem__(self, idx: int) -> dict:
        info = self.infos[idx]
        img = _load_image(os.path.join(self.root, info["file_name"]))
        rec = {
            "image_id": info.get("id", idx), "image": img,
            "height": img.shape[0], "width": img.shape[1],
            "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int32),
        }
        if self.transform is not None:
            rec = self.transform(rec)
        return rec


class ImagenetClassificationDataset:
    """Classification images (ref imagenet.py ImageNet): json with
    parallel lists or records of (file_name, label)."""

    def __init__(self, ann_file: str, root: str,
                 transform: Optional[Callable] = None):
        with open(ann_file) as f:
            data = json.load(f)
        if isinstance(data, dict) and "images" in data:
            self.items = [(im["file_name"], int(im.get("label", 0)))
                          for im in data["images"]]
        else:
            self.items = [(r["file_name"], int(r["label"])) for r in data]
        self.root = root
        self.transform = transform

    def __len__(self) -> int:
        return len(self.items)

    def select_class(self, labels: Sequence[int]
                     ) -> "ImagenetClassificationDataset":
        out = ImagenetClassificationDataset.__new__(
            ImagenetClassificationDataset)
        out.items = [it for it in self.items if it[1] in set(labels)]
        out.root = self.root
        out.transform = self.transform
        return out

    def __getitem__(self, idx: int) -> dict:
        name, label = self.items[idx]
        img = _load_image(os.path.join(self.root, name))
        rec = {"image": img, "label": np.int32(label),
               "height": img.shape[0], "width": img.shape[1]}
        if self.transform is not None:
            rec = self.transform(rec)
        return rec


class MixupDetectionDataset:
    """Detection mixup wrapper (ref mixup.py MixupDetection): blends two
    samples' images on a max-size canvas with a beta-drawn lambda and
    concatenates their boxes, each box carrying its mixing weight in a
    `box_weights` field."""

    def __init__(self, dataset, alpha: float = 1.5, beta: float = 1.5,
                 seed: int = 0):
        self.dataset = dataset
        self.alpha = alpha
        self.beta = beta
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        r1 = self.dataset[idx]
        lam = float(np.clip(self.rng.beta(self.alpha, self.beta), 0, 1))
        if lam >= 1:
            r1 = dict(r1)
            r1["box_weights"] = np.ones(len(r1["boxes"]), np.float32)
            return r1
        j = int(self.rng.integers(0, len(self.dataset)))
        r2 = self.dataset[j]
        img1 = np.asarray(r1["image"], np.float32)
        img2 = np.asarray(r2["image"], np.float32)
        H = max(img1.shape[0], img2.shape[0])
        W = max(img1.shape[1], img2.shape[1])
        mix = np.zeros((H, W, 3), np.float32)
        mix[:img1.shape[0], :img1.shape[1]] = img1 * lam
        mix[:img2.shape[0], :img2.shape[1]] += img2 * (1.0 - lam)
        out = dict(r1)
        out["image"] = mix
        out["height"], out["width"] = H, W
        out["boxes"] = np.concatenate(
            [np.asarray(r1["boxes"], np.float32).reshape(-1, 4),
             np.asarray(r2["boxes"], np.float32).reshape(-1, 4)])
        out["labels"] = np.concatenate(
            [np.asarray(r1["labels"], np.int32),
             np.asarray(r2["labels"], np.int32)])
        out["box_weights"] = np.concatenate(
            [np.full(len(r1["boxes"]), lam, np.float32),
             np.full(len(r2["boxes"]), 1.0 - lam, np.float32)])
        if "positive_map" in r1 and "positive_map" in r2:
            out["positive_map"] = np.concatenate(
                [r1["positive_map"], r2["positive_map"]])
        return out
