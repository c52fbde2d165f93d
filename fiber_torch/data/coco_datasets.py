"""COCO-format datasets over annotation JSONs, on the host.

The PyTorch counterpart of `fiber_tpu/data/coco_datasets.py`: plain JSON
parsing (no pycocotools), numpy outputs, the fixed-shape padding left to
`fiber_torch.data.loader`.  The positive map keeps the reference's
char-to-token fallbacks (beg + 1, beg + 2; end - 2, end - 3).  PIL is
imported only where an image is decoded.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from fiber_torch.data.od_to_grounding import build_detection_prompt
from fiber_torch.detection.structures import rasterize_polygons


def load_coco_json(ann_file: str) -> Tuple[List[dict], Dict[int, List[dict]],
                                           Dict[int, dict]]:
    """(images, annotations by image id, categories by id)."""
    with open(ann_file) as f:
        data = json.load(f)
    anns_by_image: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)
    cats = {c["id"]: c for c in data.get("categories", [])}
    return data["images"], anns_by_image, cats


def _char_to_token(offsets: Sequence[Tuple[int, int]], char: int
                   ) -> Optional[int]:
    for ti, (s, e) in enumerate(offsets):
        if s == e:
            continue  # a special token
        if s <= char < e:
            return ti
    return None


def create_positive_map_from_spans(offsets: Sequence[Tuple[int, int]],
                                   tokens_positive: Sequence[
                                       Sequence[Tuple[int, int]]],
                                   max_len: int,
                                   normalize: bool = True) -> np.ndarray:
    """(boxes, max_len) positive map from each box's char spans, rows
    normalised to sum to 1 (+ 1e-6) with `normalize`."""
    m = np.zeros((len(tokens_positive), max_len), np.float32)
    for j, tok_list in enumerate(tokens_positive):
        for (beg, end) in tok_list:
            beg_pos = _char_to_token(offsets, beg)
            if beg_pos is None:
                beg_pos = _char_to_token(offsets, beg + 1)
                if beg_pos is None:
                    beg_pos = _char_to_token(offsets, beg + 2)
            end_pos = _char_to_token(offsets, end - 1)
            if end_pos is None:
                end_pos = _char_to_token(offsets, end - 2)
                if end_pos is None:
                    end_pos = _char_to_token(offsets, end - 3)
            if beg_pos is None or end_pos is None:
                continue
            m[j, beg_pos:min(end_pos + 1, max_len)] = 1.0
    if normalize:
        m = m / (m.sum(-1, keepdims=True) + 1e-6)
    return m


def _load_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def _xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[:, 2:] = boxes[:, :2] + boxes[:, 2:]
    return out


def _pad_ids(ids: Sequence[int], length: int, pad: int = 0) -> np.ndarray:
    out = np.full((length,), pad, np.int32)
    n = min(len(ids), length)
    out[:n] = np.asarray(ids[:n], np.int32)
    return out


def instance_masks(anns, height: int, width: int) -> np.ndarray:
    """(N, H, W) bool: each annotation's polygons (its "segmentation"
    lists; RLE entries are skipped) rasterised."""
    masks = [rasterize_polygons([np.asarray(p) for p in
                                 (a.get("segmentation") or [])
                                 if isinstance(p, list)], height, width)
             for a in anns]
    return (np.stack(masks) if masks
            else np.zeros((0, height, width), bool))


class CocoDetectionDataset:
    """Plain COCO detection: an image and its boxes and 1-based contiguous
    labels per item (crowd boxes left out); with `return_masks` also each
    box's instance mask (N, H, W) bool, its polygons rasterised on the host
    (`detection.structures.rasterize_polygons`)."""

    def __init__(self, img_folder: str, ann_file: str,
                 transform: Optional[Callable] = None,
                 return_masks: bool = False):
        self.img_folder = img_folder
        self.return_masks = return_masks
        self.images, self.anns, self.cats = load_coco_json(ann_file)
        self.transform = transform
        self.cat_to_label = {cid: i + 1
                             for i, cid in enumerate(sorted(self.cats))}
        self.label_names = {i + 1: self.cats[cid]["name"]
                            for i, cid in enumerate(sorted(self.cats))}

    def __len__(self) -> int:
        return len(self.images)

    def _record(self, idx: int) -> dict:
        info = self.images[idx]
        anns = [a for a in self.anns.get(info["id"], [])
                if not a.get("iscrowd", 0)]
        boxes = _xywh_to_xyxy(np.asarray([a["bbox"] for a in anns],
                                         np.float32).reshape(-1, 4))
        labels = np.asarray([self.cat_to_label[a["category_id"]]
                             for a in anns], np.int32)
        return {"image_id": info["id"], "file_name": info["file_name"],
                "height": info["height"], "width": info["width"],
                "boxes": boxes, "labels": labels, "anns": anns}

    def _with_image(self, idx: int) -> dict:
        rec = self._record(idx)
        rec["image"] = _load_image(os.path.join(self.img_folder,
                                                rec["file_name"]))
        if self.return_masks:
            rec["masks"] = instance_masks(rec["anns"], rec["height"],
                                          rec["width"])
        return rec

    def __getitem__(self, idx: int) -> dict:
        rec = self._with_image(idx)
        return rec if self.transform is None else self.transform(rec)


class CocoGroundingDataset(CocoDetectionDataset):
    """Detection as grounding: each item carries a prompt of class names
    (the present ones and sampled negatives) and each box's positive map."""

    def __init__(self, img_folder: str, ann_file: str, tokenizer,
                 max_query_len: int = 256, num_negatives: int = 85,
                 shuffle_prompt: bool = True,
                 transform: Optional[Callable] = None, seed: int = 0):
        super().__init__(img_folder, ann_file)
        self.tokenizer = tokenizer
        self.max_query_len = max_query_len
        self.num_negatives = num_negatives
        self.shuffle_prompt = shuffle_prompt
        self.grounding_transform = transform
        self.rng = np.random.default_rng(seed)

    def __getitem__(self, idx: int) -> dict:
        rec = self._with_image(idx)
        prompt = build_detection_prompt(
            self.label_names, rec["labels"].tolist(),
            num_negatives=self.num_negatives, rng=self.rng,
            shuffle=self.shuffle_prompt)
        enc = self.tokenizer(prompt.caption, return_offsets_mapping=True,
                             max_length=self.max_query_len,
                             truncation=True, padding="max_length")
        spans = [[prompt.label_spans[int(l)]] for l in rec["labels"]]
        rec["caption"] = prompt.caption
        rec["input_ids"] = _pad_ids(enc["input_ids"], self.max_query_len)
        rec["attention_mask"] = _pad_ids(enc["attention_mask"],
                                         self.max_query_len)
        rec["positive_map"] = create_positive_map_from_spans(
            enc["offset_mapping"], spans, self.max_query_len,
            normalize=False)
        rec["label_to_token"] = {
            int(l): np.nonzero(create_positive_map_from_spans(
                enc["offset_mapping"], [[span]], self.max_query_len,
                normalize=False)[0])[0].tolist()
            for l, span in prompt.label_spans.items()}
        if self.grounding_transform is not None:
            rec = self.grounding_transform(rec)
        return rec


class ModulatedCocoDataset(CocoDetectionDataset):
    """Grounding data with a caption per image and each box's
    `tokens_positive` char spans (the MDETR / Flickr / mixed format)."""

    def __init__(self, img_folder: str, ann_file: str, tokenizer,
                 max_query_len: int = 256,
                 transform: Optional[Callable] = None):
        super().__init__(img_folder, ann_file)
        self.tokenizer = tokenizer
        self.max_query_len = max_query_len
        self.mod_transform = transform

    def __getitem__(self, idx: int) -> dict:
        rec = self._with_image(idx)
        caption = self.images[idx].get("caption", "")
        enc = self.tokenizer(caption, return_offsets_mapping=True,
                             max_length=self.max_query_len,
                             truncation=True, padding="max_length")
        rec["caption"] = caption
        rec["input_ids"] = _pad_ids(enc["input_ids"], self.max_query_len)
        rec["attention_mask"] = _pad_ids(enc["attention_mask"],
                                         self.max_query_len)
        rec["positive_map"] = create_positive_map_from_spans(
            enc["offset_mapping"],
            [a.get("tokens_positive", []) for a in rec["anns"]],
            self.max_query_len, normalize=True)
        if self.mod_transform is not None:
            rec = self.mod_transform(rec)
        return rec


def lvis_frequency_groups(ann_file: str) -> Dict[int, str]:
    """{contiguous label: 'r' | 'c' | 'f'} from LVIS category metadata: the
    `frequency` field, else the image count (<= 10 rare, <= 100 common,
    else frequent, the LVIS v1 protocol)."""
    with open(ann_file) as f:
        data = json.load(f)
    cats = sorted(data.get("categories", []), key=lambda c: c["id"])
    out = {}
    for i, c in enumerate(cats):
        if "frequency" in c:
            out[i + 1] = c["frequency"][0]
        else:
            n = c.get("image_count", 0)
            out[i + 1] = "r" if n <= 10 else ("c" if n <= 100 else "f")
    return out
