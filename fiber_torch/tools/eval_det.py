"""Zero-shot detection evaluation with chunked class prompts, and COCO mAP.

    python -m fiber_torch.tools.eval_det [--tiny] [--num-images 4]
        [--chunk-size 3] [--expected JSON] [--tokenizer DIR]
        [--device cuda|cpu] [--dtype float32|bfloat16]

The PyTorch counterpart of the JAX repo's `tools/eval_det.py`.  The class
vocabulary is cut into prompt chunks ("person. dog. car."), the detector
runs once per chunk and batch of images, each chunk's detections are mapped
back to the global class ids and merged per image, and `coco_map` scores
them.  `main` evaluates seeded random weights on seeded images (a smoke run
of the whole path: its mAP means nothing): with `--tiny` as the JAX tool
does (its tiny config, five classes, one image a pass, one medium
ground-truth box an image); without it FIBER-B at the 800x1344 bucket, ten
COCO classes, two images a pass, and a small, a medium and a large
ground-truth box an image, so that every metric has ground truth.
`--expected` asserts metrics against [[name, mean, tolerance], ...].

Under a process group (`FIBER_COORDINATOR`, as for the trainers) each
rank evaluates the images `range(rank, n, world)`, `merge_eval_predictions`
gathers the per-image predictions on every rank, and rank 0 prints the
scores; with one process the merge is the identity.

In a running profiler's trace a call of `predict_detections` is the span
`det.call`: a chunk's prompt and tokens are `det.prompt`, each pass
`det.pass` (its padding `det.stage`, `detection_inference`'s spans, the
read-back `det.readback`, the per-image merge `det.merge`), and the last
concatenation `det.merge` again (`fiber_torch/utils/profiling.py::span`).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fiber_torch.data.od_to_grounding import (build_detection_prompt,
                                              build_label_to_token_map,
                                              chunk_class_names)
from fiber_torch.data.tokenizer import get_tokenizer
from fiber_torch.detection.detector import (DetectorConfig, GroundingDetector,
                                            detection_inference)
from fiber_torch.detection.evaluation import coco_map
from fiber_torch.detection.postprocess import label_to_token_matrix
from fiber_torch.parallel.multihost import (maybe_initialize_distributed,
                                            merge_eval_predictions, print0,
                                            process_count, process_index,
                                            rank_device)
from fiber_torch.train.metrics import check_expected_results
from fiber_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TINY_CLASSES = {1: "person", 2: "dog", 3: "car", 4: "cat", 5: "bus"}
# the first ten COCO categories
COCO_CLASSES = {1: "person", 2: "bicycle", 3: "car", 4: "motorcycle",
                5: "airplane", 6: "bus", 7: "train", 8: "truck", 9: "boat",
                10: "traffic light"}


def evaluate_detection(model: GroundingDetector, images: np.ndarray,
                       image_sizes: np.ndarray, label_names: Dict[int, str],
                       ground_truths: Sequence[Dict], tokenizer,
                       chunk_size: int = 40, batch: int = 1,
                       **pp_kwargs) -> Dict[str, float]:
    """`coco_map` of `predict_detections` against `ground_truths`."""
    return coco_map(predict_detections(model, images, image_sizes,
                                       label_names, tokenizer, chunk_size,
                                       batch, **pp_kwargs), ground_truths)


def predict_detections(model: GroundingDetector, images: np.ndarray,
                       image_sizes: np.ndarray, label_names: Dict[int, str],
                       tokenizer, chunk_size: int = 40, batch: int = 1,
                       **pp_kwargs) -> List[Dict[str, np.ndarray]]:
    """Chunked-class zero-shot detection over `images` (N, H, W, 3) staged
    at the model's image size, `image_sizes` (N, 2) their true (h, w): each
    image's merged detections {boxes, scores, labels}, in image order.
    Under a process group this rank runs the images rank, rank + world,
    ... and the predictions of every rank are gathered on every rank."""
    with span("det.call"):
        cfg = model.cfg
        n_total = len(images)
        my_ids = list(range(process_index(), n_total, process_count()))
        images, image_sizes = images[my_ids], image_sizes[my_ids]
        n = len(images)
        merged = [{"boxes": [], "scores": [], "labels": []} for _ in range(n)]
        for chunk in chunk_class_names(label_names, chunk_size):
            with span("det.prompt"):
                names = {l: label_names[l] for l in chunk}
                prompt = build_detection_prompt(
                    names, chunk, num_negatives=0,
                    rng=np.random.default_rng(0), shuffle=False)
                l2t_local = build_label_to_token_map(tokenizer, prompt,
                                                     cfg.max_query_len)
                # local ids 1..len(chunk) -> the global label ids
                local_to_global = {i + 1: l for i, l in enumerate(chunk)}
                l2t = {i + 1: l2t_local[l] for i, l in enumerate(chunk)}
                agg = label_to_token_matrix(l2t, len(chunk), cfg.max_query_len)
                enc = tokenizer.batch([prompt.caption] * batch,
                                      max_length=cfg.max_query_len)
            for i in range(0, n, batch):
                with span("det.pass"):
                    with span("det.stage"):
                        imgs = images[i:i + batch]
                        sizes = image_sizes[i:i + batch]
                        pad = batch - len(imgs)
                        if pad:
                            imgs = np.concatenate([imgs, np.zeros(
                                (pad,) + imgs.shape[1:], imgs.dtype)])
                            sizes = np.concatenate(
                                [sizes, np.ones((pad, 2), np.float32)])
                    dets = detection_inference(model, {
                        "images": imgs, "input_ids": enc["input_ids"],
                        "attention_mask": enc["attention_mask"],
                        "image_sizes": np.asarray(sizes, np.float32)}, agg,
                        **pp_kwargs)
                    with span("det.readback"):
                        boxes, scores, labels, valid = (t.cpu().numpy()
                                                        for t in dets)
                    with span("det.merge"):
                        for j in range(batch - pad):
                            v = valid[j]
                            merged[i + j]["boxes"].append(boxes[j][v])
                            merged[i + j]["scores"].append(scores[j][v])
                            merged[i + j]["labels"].append(np.asarray(
                                [local_to_global[int(c)]
                                 for c in labels[j][v]], np.int64))
        with span("det.merge"):
            local = {img_id: {
                "boxes": np.concatenate(m["boxes"]) if m["boxes"] else
                np.zeros((0, 4)),
                "scores": np.concatenate(m["scores"]) if m["scores"] else
                np.zeros((0,)),
                "labels": np.concatenate(m["labels"]) if m["labels"] else
                np.zeros((0,), np.int64),
            } for img_id, m in zip(my_ids, merged)}
            all_preds = merge_eval_predictions(local)
            return [all_preds[i] for i in range(n_total)]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--num-images", type=int, default=4)
    p.add_argument("--chunk-size", type=int, default=3)
    p.add_argument("--expected", default=None,
                   help="JSON list of [metric, mean, tol] asserts")
    p.add_argument("--tokenizer", default=None,
                   help="a local tokenizer (a directory with vocab.json and "
                        "merges.txt); the whitespace tokenizer without one")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                   help="compute dtype (default: float32 with --tiny, "
                        "bfloat16 otherwise)")
    args = p.parse_args(argv)
    maybe_initialize_distributed(
        backend="gloo" if args.device == "cpu" else None)

    dtype = _DTYPES[args.dtype or ("float32" if args.tiny else "bfloat16")]
    if args.tiny:
        cfg = DetectorConfig.tiny_test(compute_dtype=dtype)
        names, batch, gt_boxes = TINY_CLASSES, 1, [[4., 4., 40., 40.]]
    else:
        cfg = DetectorConfig(image_size=(800, 1344), compute_dtype=dtype)
        names, batch = COCO_CLASSES, 2
        gt_boxes = [[10., 10., 30., 30.], [100., 80., 170., 150.],
                    [300., 200., 600., 500.]]
    model = GroundingDetector(cfg, device=rank_device(args.device), seed=0)
    H, W = cfg.image_size
    rng = np.random.default_rng(0)
    tok = get_tokenizer(args.tokenizer)

    images = rng.standard_normal(
        (args.num_images, H, W, 3)).astype(np.float32)
    sizes = np.tile(np.asarray([[H, W]], np.float32), (args.num_images, 1))
    gts = [{"boxes": np.array(gt_boxes),
            "labels": rng.integers(1, len(names) + 1, len(gt_boxes))}
           for _ in range(args.num_images)]
    metrics = evaluate_detection(model, images, sizes, names, gts, tok,
                                 chunk_size=args.chunk_size, batch=batch,
                                 pre_nms_top_n=100, post_nms_top_n=20)
    print0(json.dumps(metrics))
    if args.expected:
        errs = check_expected_results(metrics, json.loads(args.expected))
        if errs:
            raise SystemExit("EXPECTED_RESULTS violated: " + "; ".join(errs))
    return metrics


if __name__ == "__main__":
    main()
