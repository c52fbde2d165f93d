"""Detection input pipeline: multi-scale resize buckets, aspect-ratio
grouping, fixed-shape padded batches, on the host.

The PyTorch counterpart of `fiber_tpu/data/loader.py`: the shorter side of
every image of a batch goes to one `min_size` drawn from the list (the
longer capped at `max_size`), and the batch is padded to one of 2 x
len(min_sizes) bucket shapes (landscape or portrait), so that the device
sees few shapes; the boxes are padded to `max_boxes` with a validity mask.
The resize is `jax.image.resize`'s antialiased "bilinear": the triangle
weights of `scale_and_translate` (`device_transforms.
static_resize_weights`), applied on the host in fp32.  Under a process
group each rank takes the strided shard `indices[rank::world]` of every
epoch's shuffled indices, as the JAX package's hosts do.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from fiber_torch.data.device_transforms import static_resize_weights
from fiber_torch.parallel.multihost import process_count, process_index

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def resize_min_size(h: int, w: int, min_size: int, max_size: int
                    ) -> Tuple[int, int]:
    """The shorter side to min_size, the longer capped at max_size."""
    short, long = (h, w) if h < w else (w, h)
    size = min_size
    if long * size / short > max_size:
        size = int(round(max_size * short / long))
    if short == size:
        return h, w
    if h < w:
        return size, int(size * w / h)
    return int(size * h / w), size


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(h, w, C) fp32 -> (nh, nw, C): the antialiased triangle resample of
    `jax.image.resize(img, (nh, nw, C), "bilinear")`; an axis whose size
    stays is left alone, as there."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    for axis, n in ((0, nh), (1, nw)):
        m = x.shape[axis]
        if m == n:
            continue
        w = static_resize_weights(m, n)                        # (m, n)
        x = (torch.einsum("hwc,ho->owc", x, w) if axis == 0
             else torch.einsum("hwc,wo->hoc", x, w))
    return x.numpy()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DetectionBatcher:
    """Batches a COCO-style dataset into fixed-shape numpy arrays.

    Dataset items hold image (H, W, 3) uint8, boxes (G, 4) xyxy, labels
    (G,), and for grounding input_ids / attention_mask / positive_map;
    `dataset.images` holds each image's width and height, which group the
    batches by orientation without decoding an image."""

    def __init__(self, dataset, batch_size: int,
                 min_sizes: Sequence[int] = (480, 560, 640, 720, 800),
                 max_size: int = 1333, pad_multiple: int = 32,
                 max_boxes: int = 100, shuffle: bool = True,
                 hflip_prob: float = 0.5, min_items: int = 0,
                 seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.min_sizes = tuple(min_sizes)
        self.max_size = max_size
        self.pad_multiple = pad_multiple
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.hflip_prob = hflip_prob
        self.rng = np.random.default_rng(seed)
        # a small dataset's indices repeat until at least min_items
        n = len(dataset)
        reps = max(1, -(-max(min_items, batch_size) // n))
        self.indices = np.tile(np.arange(n), reps)

    def bucket_shape(self, min_size: int, landscape: bool
                     ) -> Tuple[int, int]:
        short = _round_up(min_size, self.pad_multiple)
        long = _round_up(self.max_size, self.pad_multiple)
        return (short, long) if landscape else (long, short)

    def _prepare(self, rec: dict, min_size: int, bucket: Tuple[int, int],
                 flip: bool) -> dict:
        img = rec["image"].astype(np.float32) / 255.0
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        h, w = img.shape[:2]
        nh, nw = resize_min_size(h, w, min_size, self.max_size)
        nh, nw = min(nh, bucket[0]), min(nw, bucket[1])
        if (nh, nw) != (h, w):
            img = resize_bilinear(img, nh, nw)
        boxes = rec["boxes"] * np.asarray([nw / w, nh / h, nw / w, nh / h],
                                          np.float32)
        if flip:
            img = img[:, ::-1]
            x1 = nw - boxes[:, 2] - 1
            x2 = nw - boxes[:, 0] - 1
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
        padded = np.zeros(bucket + (3,), np.float32)
        padded[:nh, :nw] = img
        G = self.max_boxes
        gt = np.zeros((G, 4), np.float32)
        labels = np.zeros((G,), np.int32)
        n = min(len(boxes), G)
        gt[:n] = boxes[:n]
        labels[:n] = rec["labels"][:n]
        valid = np.zeros((G,), bool)
        valid[:n] = True
        out = {"images": padded, "gt_boxes": gt, "gt_labels": labels,
               "gt_valid": valid,
               "image_sizes": np.asarray([nh, nw], np.float32)}
        if "positive_map" in rec:
            pm = np.zeros((G, rec["positive_map"].shape[1]), np.float32)
            pm[:n] = rec["positive_map"][:n]
            out["positive_map"] = pm
            out["input_ids"] = rec["input_ids"]
            out["attention_mask"] = rec["attention_mask"]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        # this process's strided shard
        idx = idx[process_index()::process_count()]
        # group by the annotation's orientation (no image decode)
        landscape: List[int] = []
        portrait: List[int] = []
        for i in idx:
            info = self.ds.images[int(i)]
            (landscape if info["width"] >= info["height"]
             else portrait).append(int(i))
        batches: List[List[int]] = []
        for group in (landscape, portrait):
            for s in range(0, len(group) - self.batch_size + 1,
                           self.batch_size):
                batches.append(group[s:s + self.batch_size])
        if self.shuffle:
            self.rng.shuffle(batches)
        for batch_idx in batches:
            min_size = int(self.rng.choice(self.min_sizes))
            info = self.ds.images[batch_idx[0]]
            bucket = self.bucket_shape(min_size,
                                       info["width"] >= info["height"])
            flip = (self.hflip_prob > 0
                    and self.rng.random() < self.hflip_prob)
            items = [self._prepare(self.ds[i], min_size, bucket, flip)
                     for i in batch_idx]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
