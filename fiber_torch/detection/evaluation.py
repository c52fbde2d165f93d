"""Detection / grounding evaluators (host side, numpy).

The port's copy of `fiber_tpu/detection/evaluation.py`, line for line (the
same float64 arithmetic and stable sorts, so the results are bit-equal):

* COCO-style AP / AR (`coco_map`): COCOeval semantics (greedy per-(image,
  class) matching at 10 IoU thresholds with crowd / ignore handling,
  101-point interpolated precision, the area-range APs / APm / APl and
  AR@{1,10,100}), for bbox, segm (rasterised masks) and keypoint (OKS)
  IoU types.
* The simple greedy matcher and AP (`match_detections`,
  `average_precision`).
* Box-proposal AR (`box_proposal_ar`, the +1 pixel-width IoU of the
  reference's boxlist_iou).
* Flickr30k phrase-grounding Recall@k (`flickr_grounding_recall`).
* RefExp P@k (`refexp_precision`, `refexp_accuracy`): generalized IoU,
  not IoU, per dataset name.
* LVIS "fixed AP" (`lvis_fixed_ap`) and the classic federated LVIS AP
  with rare / common / frequent splits (`lvis_classic_eval`).
* PASCAL VOC mAP (`voc_detection_map`, the 07 11-point metric by
  default).
* The EXPECTED_RESULTS regression assert `check_expected_results`,
  re-exported from `fiber_torch/train/metrics.py`.

Every function takes numpy: the port's detections come out of
`detection_inference` as tensors, and `tools/eval_det.py::
predict_detections` moves them to the host once a batch, where they enter
these evaluators.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fiber_torch.train.metrics import check_expected_results  # noqa: F401

# COCO 17-keypoint OKS sigmas (pycocotools cocoeval.py Params.kpt_oks_sigmas)
COCO_KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89], np.float64) / 10.0

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_matrix(a: np.ndarray, b: np.ndarray,
                b_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise IoU of xyxy boxes; for crowd GT columns the denominator
    is the detection area only (pycocotools maskUtils.iou semantics)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    if b_crowd is not None and b_crowd.any():
        union = np.where(b_crowd[None, :].astype(bool), area_a[:, None],
                         union)
    return inter / np.maximum(union, 1e-12)


def _giou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise generalized IoU (ref layers/set_loss.py
    generalized_box_iou; used by RefExpEvaluator, refexp.py:71)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    iou = _iou_matrix(a, b)
    lt = np.minimum(a[:, None, :2], b[None, :, :2])
    rb = np.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    hull = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    lt_i = np.maximum(a[:, None, :2], b[None, :, :2])
    rb_i = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh_i = np.clip(rb_i - lt_i, 0, None)
    inter = wh_i[..., 0] * wh_i[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return iou - (hull - union) / np.maximum(hull, 1e-12)


def _mask_iou_matrix(a: np.ndarray, b: np.ndarray,
                     b_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise IoU of binary masks a (D,H,W), b (G,H,W)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    a = np.asarray(a, bool).reshape(len(a), -1)
    b = np.asarray(b, bool).reshape(len(b), -1)
    inter = (a[:, None, :] & b[None, :, :]).sum(-1).astype(np.float64)
    area_a = a.sum(-1).astype(np.float64)
    area_b = b.sum(-1).astype(np.float64)
    union = area_a[:, None] + area_b[None, :] - inter
    if b_crowd is not None and b_crowd.any():
        union = np.where(b_crowd[None, :].astype(bool), area_a[:, None],
                         union)
    return inter / np.maximum(union, 1e-12)


def _oks_matrix(d_kpts: np.ndarray, g_kpts: np.ndarray,
                g_areas: np.ndarray,
                sigmas: Optional[np.ndarray] = None) -> np.ndarray:
    """Object keypoint similarity between detections (D, K, 3) and GT
    (G, K, 3) with GT box areas (pycocotools computeOks semantics)."""
    if len(d_kpts) == 0 or len(g_kpts) == 0:
        return np.zeros((len(d_kpts), len(g_kpts)), np.float64)
    if sigmas is None:
        sigmas = COCO_KPT_SIGMAS
    vars_ = (sigmas * 2) ** 2
    d = np.asarray(d_kpts, np.float64)
    g = np.asarray(g_kpts, np.float64)
    dx = d[:, None, :, 0] - g[None, :, :, 0]
    dy = d[:, None, :, 1] - g[None, :, :, 1]
    vis = g[None, :, :, 2] > 0                    # (1, G, K)
    e = (dx ** 2 + dy ** 2) / vars_[None, None, :] / (
        np.asarray(g_areas, np.float64)[None, :, None] + np.spacing(1)) / 2.0
    oks = np.where(vis, np.exp(-e), 0.0).sum(-1)
    k = np.maximum(vis.sum(-1), 1)
    return oks / k


def match_detections(det_boxes: np.ndarray, det_scores: np.ndarray,
                     gt_boxes: np.ndarray, iou_thr: float
                     ) -> np.ndarray:
    """Greedy score-ordered matching (each GT used once, detections
    matched to the best available GT).  Kept for the simple/LVIS paths."""
    matched = np.zeros(len(det_boxes), bool)
    if len(gt_boxes) == 0 or len(det_boxes) == 0:
        return matched
    ious = _iou_matrix(det_boxes, gt_boxes)
    taken = np.zeros(len(gt_boxes), bool)
    for d in np.argsort(-det_scores, kind="mergesort"):
        avail = ~taken
        if not avail.any():
            break
        cand = np.where(avail, ious[d], -1.0)
        g = int(cand.argmax())
        if cand[g] >= iou_thr:
            taken[g] = True
            matched[d] = True
    return matched


def average_precision(scores: np.ndarray, matched: np.ndarray,
                      num_gt: int) -> float:
    """COCO 101-point interpolated AP for one class/IoU threshold."""
    if num_gt == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    rec_thrs = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rec_thrs, side="left")
    p = np.zeros_like(rec_thrs)
    valid = idx < len(precision)
    p[valid] = precision[idx[valid]]
    return float(p.mean())


# ---------------------------------------------------------------------------
# COCOeval-faithful AP/AR
# ---------------------------------------------------------------------------
def _match_image(ious: np.ndarray, gt_ignore: np.ndarray,
                 iou_thrs: np.ndarray, gt_crowd: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy matching for one (image, class) at all thresholds.

    ious: (D, G) with dets already score-sorted and gts sorted
    ignored-last.  Returns (dt_match (T, D) int gt index or -1,
    dt_ignore (T, D) bool) — pycocotools cocoeval.evaluateImg loop.
    """
    T = len(iou_thrs)
    D, G = ious.shape
    dtm = np.full((T, D), -1, np.int64)
    dtig = np.zeros((T, D), bool)
    if G == 0:
        return dtm, dtig
    gtm = np.full((T, G), -1, np.int64)
    for ti, t in enumerate(iou_thrs):
        thr = min(t, 1 - 1e-10)
        for d in range(D):
            best_iou = thr
            m = -1
            for g in range(G):
                if gtm[ti, g] >= 0 and not gt_crowd[g]:
                    continue
                # gts are sorted non-ignored first: once we have a real
                # match, never trade it for an ignored gt
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                m = g
            if m == -1:
                continue
            dtig[ti, d] = gt_ignore[m]
            dtm[ti, d] = m
            gtm[ti, m] = d
    return dtm, dtig


def coco_map(predictions: Sequence[Dict], ground_truths: Sequence[Dict],
             iou_thrs: Optional[np.ndarray] = None,
             max_dets: Sequence[int] = (1, 10, 100),
             iou_type: str = "bbox",
             kpt_sigmas: Optional[np.ndarray] = None) -> Dict[str, float]:
    """COCO AP/AR with full COCOeval semantics.

    predictions[i]: {boxes (N,4) xyxy, scores (N,), labels (N,)}
      + "masks" (N,H,W) bool for iou_type="segm"
      + "keypoints" (N,K,3) for iou_type="keypoints"
    ground_truths[i]: {boxes (M,4), labels (M,)}
      + optional "iscrowd" (M,), "areas" (M,)
      + "masks"/"keypoints" per iou_type.

    Returns {mAP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100, ARs, ARm,
    ARl} (nan where no GT exists), matching pycocotools summarize().
    """
    if iou_thrs is None:
        iou_thrs = np.linspace(0.5, 0.95, 10)
    iou_thrs = np.asarray(iou_thrs, np.float64)
    rec_thrs = np.linspace(0.0, 1.0, 101)
    max_det = int(max(max_dets))
    if iou_type == "keypoints":
        areas = [("all", AREA_RNG["all"]), ("medium", AREA_RNG["medium"]),
                 ("large", AREA_RNG["large"])]
    else:
        areas = list(AREA_RNG.items())
    T, A, M = len(iou_thrs), len(areas), len(max_dets)

    classes = sorted({int(l) for gt in ground_truths
                      for l in np.asarray(gt["labels"]).reshape(-1).tolist()})
    K = len(classes)
    precision = np.full((T, len(rec_thrs), K, A, M), -1.0)
    recall = np.full((T, K, A, M), -1.0)

    n_img = len(predictions)
    # pre-extract per-image arrays once
    imgs = []
    for pred, gt in zip(predictions, ground_truths):
        p_boxes = np.asarray(pred.get("boxes", np.zeros((0, 4))),
                             np.float64).reshape(-1, 4)
        p_scores = np.asarray(pred.get("scores", np.zeros(0)), np.float64
                              ).reshape(-1)
        p_labels = np.asarray(pred.get("labels", np.zeros(0)), np.int64
                              ).reshape(-1)
        g_boxes = np.asarray(gt.get("boxes", np.zeros((0, 4))),
                             np.float64).reshape(-1, 4)
        g_labels = np.asarray(gt.get("labels", np.zeros(0)), np.int64
                              ).reshape(-1)
        g_crowd = np.asarray(gt.get("iscrowd", np.zeros(len(g_boxes))),
                             bool).reshape(-1)
        if "areas" in gt:
            g_areas = np.asarray(gt["areas"], np.float64).reshape(-1)
        else:
            g_areas = (np.clip(g_boxes[:, 2] - g_boxes[:, 0], 0, None)
                       * np.clip(g_boxes[:, 3] - g_boxes[:, 1], 0, None))
        imgs.append((p_boxes, p_scores, p_labels, pred, g_boxes, g_labels,
                     g_crowd, g_areas, gt))

    for ki, cls in enumerate(classes):
        # per-image eval results for this class
        per_img = []  # (scores_sorted, dtm, dtig, gt_ignore_per_area,
        #               det_areas, n_gt_per_area)
        for (p_boxes, p_scores, p_labels, pred, g_boxes, g_labels,
             g_crowd, g_areas, gt) in imgs:
            dmask = p_labels == cls
            gmask = g_labels == cls
            if not dmask.any() and not gmask.any():
                continue
            scores = p_scores[dmask]
            order = np.argsort(-scores, kind="mergesort")[:max_det]
            scores = scores[order]
            dboxes = p_boxes[dmask][order]
            gboxes = g_boxes[gmask]
            crowd = g_crowd[gmask]
            gareas = g_areas[gmask]

            if iou_type == "bbox":
                d_areas = (np.clip(dboxes[:, 2] - dboxes[:, 0], 0, None)
                           * np.clip(dboxes[:, 3] - dboxes[:, 1], 0, None))
            elif iou_type == "segm":
                d_masks = np.asarray(pred["masks"])[dmask][order]
                d_areas = d_masks.reshape(len(d_masks), -1).sum(-1).astype(
                    np.float64) if len(d_masks) else np.zeros(0)
            else:  # keypoints: det area from its box
                d_areas = (np.clip(dboxes[:, 2] - dboxes[:, 0], 0, None)
                           * np.clip(dboxes[:, 3] - dboxes[:, 1], 0, None))

            # area-range matching: gt ignore flags depend on the range,
            # so matching is run per range (pycocotools does the same:
            # one evaluateImg per (img, cat, aRng))
            entry = {"scores": scores, "d_areas": d_areas}
            for ai, (_, (lo, hi)) in enumerate(areas):
                gt_ig = crowd | (gareas < lo) | (gareas > hi)
                # sort gts: non-ignored first (stable)
                gorder = np.argsort(gt_ig, kind="mergesort")
                if iou_type == "bbox":
                    ious = _iou_matrix(dboxes, gboxes[gorder],
                                       crowd[gorder])
                elif iou_type == "segm":
                    g_masks = np.asarray(gt["masks"])[gmask]
                    ious = _mask_iou_matrix(d_masks, g_masks[gorder],
                                            crowd[gorder])
                else:
                    d_kpts = np.asarray(pred["keypoints"])[dmask][order]
                    g_kpts = np.asarray(gt["keypoints"])[gmask]
                    ious = _oks_matrix(d_kpts, g_kpts[gorder],
                                       gareas[gorder], kpt_sigmas)
                dtm, dtig = _match_image(ious, gt_ig[gorder], iou_thrs,
                                         crowd[gorder])
                # unmatched dets outside the range are ignored
                out_rng = (d_areas < lo) | (d_areas > hi)
                dtig = dtig | ((dtm < 0) & out_rng[None, :])
                entry[ai] = (dtm, dtig, int((~gt_ig).sum()))
            per_img.append(entry)

        if not per_img:
            continue
        all_scores = np.concatenate([e["scores"] for e in per_img]) \
            if per_img else np.zeros(0)
        sort_idx = np.argsort(-all_scores, kind="mergesort")
        for ai in range(A):
            npig = sum(e[ai][2] for e in per_img)
            if npig == 0:
                continue
            dtm_all = np.concatenate([e[ai][0] for e in per_img], axis=1)
            dtig_all = np.concatenate([e[ai][1] for e in per_img], axis=1)
            for mi, md in enumerate(max_dets):
                # slice each image's dets to md, then merge by score
                keep = np.concatenate(
                    [np.arange(len(e["scores"])) < md for e in per_img])
                idx = sort_idx[keep[sort_idx]]
                dtm = dtm_all[:, idx]
                dtig = dtig_all[:, idx]
                tps = (dtm >= 0) & ~dtig
                fps = (dtm < 0) & ~dtig
                tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(T):
                    tp, fp = tp_cum[ti], fp_cum[ti]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                    q = np.zeros(len(rec_thrs))
                    if nd:
                        pr = pr.copy()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, rec_thrs, side="left")
                        ok = inds < nd
                        q[ok] = pr[inds[ok]]
                    precision[ti, :, ki, ai, mi] = q

    def _ap(thr=None, area="all", md=100):
        ai = [i for i, (n, _) in enumerate(areas) if n == area]
        mi = [i for i, m in enumerate(max_dets) if m == md]
        s = precision
        if thr is not None:
            s = s[np.abs(iou_thrs - thr) < 1e-6]
        s = s[:, :, :, ai, mi]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else float("nan")

    def _ar(area="all", md=100):
        ai = [i for i, (n, _) in enumerate(areas) if n == area]
        mi = [i for i, m in enumerate(max_dets) if m == md]
        s = recall[:, :, ai, mi]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else float("nan")

    md_top = int(max(max_dets))
    out = {
        "mAP": _ap(md=md_top),
        "AP50": _ap(thr=0.5, md=md_top),
        "AP75": _ap(thr=0.75, md=md_top),
        "APm": _ap(area="medium", md=md_top),
        "APl": _ap(area="large", md=md_top),
    }
    if iou_type != "keypoints":
        out["APs"] = _ap(area="small", md=md_top)
        out["ARs"] = _ar(area="small", md=md_top)
    for md in max_dets:
        out[f"AR{md}"] = _ar(md=md)
    out["ARm"] = _ar(area="medium", md=md_top)
    out["ARl"] = _ar(area="large", md=md_top)
    return out


# ---------------------------------------------------------------------------
def _legacy_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """boxlist_iou semantics (structures/boxlist_ops.py:96-130): +1
    inclusive pixel widths — the reference's proposal-AR IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1.0, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def box_proposal_ar(predictions: Sequence[Dict],
                    ground_truths: Sequence[Dict],
                    area: str = "all", limit: Optional[int] = None,
                    thresholds: Optional[np.ndarray] = None,
                    legacy_plus_one: bool = True) -> Dict[str, float]:
    """Detection-proposal average recall (ref od_eval.py:241-363
    evaluate_box_proposals): proposals ranked by score greedily cover GT
    boxes by max IoU; AR = mean recall over IoU 0.5:0.05:0.95.

    predictions[i]: {boxes (N,4) xyxy, scores (N,)};
    ground_truths[i]: {boxes (M,4), optional areas (M,)}.
    legacy_plus_one matches the reference's boxlist_iou (+1 inclusive
    widths); pass False for modern IoU.
    """
    rngs = {
        "all": (0.0, 1e10), "small": (0.0, 32 ** 2),
        "medium": (32 ** 2, 96 ** 2), "large": (96 ** 2, 1e10),
        "96-128": (96 ** 2, 128 ** 2), "128-256": (128 ** 2, 256 ** 2),
        "256-512": (256 ** 2, 512 ** 2), "512-inf": (512 ** 2, 1e10),
    }
    lo, hi = rngs[area]
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    gt_overlaps = []
    num_pos = 0
    for pred, gt in zip(predictions, ground_truths):
        g = np.asarray(gt.get("boxes", np.zeros((0, 4))),
                       np.float64).reshape(-1, 4)
        if len(g) == 0:
            continue
        if "areas" in gt:
            ga = np.asarray(gt["areas"], np.float64).reshape(-1)
        else:
            ga = (np.clip(g[:, 2] - g[:, 0], 0, None)
                  * np.clip(g[:, 3] - g[:, 1], 0, None))
        valid = (ga >= lo) & (ga <= hi)
        g = g[valid]
        num_pos += len(g)
        if len(g) == 0:
            continue
        p = np.asarray(pred.get("boxes", np.zeros((0, 4))),
                       np.float64).reshape(-1, 4)
        if len(p) == 0:
            continue
        scores = np.asarray(pred.get("scores", np.zeros(len(p))),
                            np.float64).reshape(-1)
        order = np.argsort(-scores, kind="stable")
        p = p[order]
        if limit is not None and len(p) > limit:
            p = p[:limit]
        overlaps = (_legacy_iou_matrix(p, g) if legacy_plus_one
                    else _iou_matrix(p, g))
        ov = np.zeros(len(g))
        for j in range(min(len(p), len(g))):
            per_gt_max = overlaps.max(axis=0)
            per_gt_arg = overlaps.argmax(axis=0)
            gi = int(per_gt_max.argmax())
            bi = int(per_gt_arg[gi])
            ov[j] = overlaps[bi, gi]
            overlaps[bi, :] = -1
            overlaps[:, gi] = -1
        gt_overlaps.append(ov)
    if not gt_overlaps:
        return {"ar": 0.0, "num_pos": 0}
    all_ov = np.sort(np.concatenate(gt_overlaps))
    recalls = np.array([(all_ov >= t).sum() / max(num_pos, 1)
                        for t in thresholds])
    return {"ar": float(recalls.mean()), "num_pos": int(num_pos),
            "recalls": recalls}


# ---------------------------------------------------------------------------
def flickr_grounding_recall(predictions: Sequence[Dict],
                            ground_truths: Sequence[Dict],
                            ks: Sequence[int] = (1, 5, 10),
                            iou_thresh: float = 0.5,
                            merge_boxes: bool = False) -> Dict[str, float]:
    """Phrase grounding R@k (ref flickr_eval.py:261-443): one entry per
    PHRASE; predictions[i] = {boxes (N,4) score-sorted desc};
    ground_truths[i] = {boxes (M,4)}.  A phrase is recalled@k if any of
    the top-k predicted boxes reaches IoU >= iou_thresh with any of its
    GT boxes (merged into one enclosing box when merge_boxes, the
    reference's merged-boxes protocol).  k=-1 gives the upper bound over
    all predicted boxes.
    """
    out = {f"r@{k}": 0 for k in ks}
    n = 0
    for pred, gt in zip(predictions, ground_truths):
        g = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        if len(g) == 0:
            continue
        if merge_boxes and len(g) > 1:
            g = np.array([[g[:, 0].min(), g[:, 1].min(),
                           g[:, 2].max(), g[:, 3].max()]])
        n += 1
        p = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        ious = _iou_matrix(p, g)
        best = ious.max(axis=1) if len(p) else np.zeros(0)
        for k in ks:
            top = best if k == -1 else best[:k]
            if len(top) and top.max() >= iou_thresh:
                out[f"r@{k}"] += 1
    return {k: v / max(n, 1) for k, v in out.items()}


# ---------------------------------------------------------------------------
def refexp_precision(predictions: Sequence[Dict],
                     ground_truths: Sequence[Dict],
                     ks: Sequence[int] = (1, 5, 10),
                     thresh_iou: float = 0.5) -> Dict[str, float]:
    """RefExp P@k (ref refexp.py:18-88): a referral is correct@k if any
    of the top-k scored boxes has **generalized** IoU >= thresh with the
    single target box (the reference uses generalized_box_iou,
    refexp.py:71).  predictions[i]: {boxes (N,4), scores (N,)};
    ground_truths[i]: {boxes (1,4), optional dataset_name}.

    Returns {"P@k": ...} overall plus "P@k_<dataset>" per dataset_name.
    """
    score: Dict[str, float] = {}
    count: Dict[str, float] = {}
    for pred, gt in zip(predictions, ground_truths):
        g = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[:1]
        name = gt.get("dataset_name", "refexp")
        p = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        s = np.asarray(pred.get("scores", np.arange(len(p), 0, -1)),
                       np.float64).reshape(-1)
        # reference sorts (score, box) tuples in reverse lexicographic
        # order — equal scores tie-break on box coords; plain stable
        # sort on -score matches for distinct scores
        order = np.argsort(-s, kind="mergesort")
        p = p[order]
        giou = _giou_matrix(p, g)[:, 0] if len(g) else np.zeros(len(p))
        count[name] = count.get(name, 0) + 1
        for k in ks:
            key = f"P@{k}_{name}"
            score.setdefault(key, 0.0)
            if len(giou) and giou[:k].max() >= thresh_iou:
                score[key] += 1
    out: Dict[str, float] = {}
    for k in ks:
        tot = sum(count.values())
        hits = sum(score.get(f"P@{k}_{n}", 0.0) for n in count)
        out[f"P@{k}"] = hits / max(tot, 1)
        for n, c in count.items():
            out[f"P@{k}_{n}"] = score.get(f"P@{k}_{n}", 0.0) / max(c, 1)
    return out


def refexp_accuracy(predictions: Sequence[Dict],
                    ground_truths: Sequence[Dict]) -> float:
    """Top-1 RefExp accuracy (GIoU >= 0.5, ref refexp.py:71)."""
    return refexp_precision(predictions, ground_truths, ks=(1,))["P@1"]


# ---------------------------------------------------------------------------
def lvis_fixed_ap(predictions: Sequence[Dict],
                  ground_truths: Sequence[Dict],
                  dets_per_class: int = 10000,
                  iou_thrs: Optional[np.ndarray] = None,
                  class_groups: Optional[Dict[int, str]] = None
                  ) -> Dict[str, float]:
    """LVIS "fixed AP" (ref lvis/lvis_eval.py:767 LvisEvaluatorFixedAP):
    instead of a per-image detection cap, each class keeps its global
    top-`dets_per_class` detections across the whole dataset, removing
    the score-calibration artifact of per-image limits.

    class_groups optionally maps class id -> "r"/"c"/"f" for the
    rare/common/frequent AP breakdown.
    """
    if iou_thrs is None:
        iou_thrs = np.arange(0.5, 0.96, 0.05)
    classes = sorted({int(l) for gt in ground_truths
                      for l in np.asarray(gt["labels"]).tolist()})
    per_class_ap: Dict[int, float] = {}
    for cls in classes:
        # pool this class's detections over the dataset, keep global top-k
        entries = []  # (score, image_idx, box)
        for i, pred in enumerate(predictions):
            mask = np.asarray(pred["labels"]) == cls
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)[
                mask]
            scores = np.asarray(pred["scores"], np.float64)[mask]
            for b, s in zip(boxes, scores):
                entries.append((float(s), i, b))
        entries.sort(key=lambda e: -e[0])
        entries = entries[:dets_per_class]

        aps = []
        for thr in iou_thrs:
            num_gt = 0
            gt_taken = []
            for gt in ground_truths:
                g_mask = np.asarray(gt["labels"]) == cls
                num_gt += int(g_mask.sum())
                gt_taken.append(np.zeros(int(g_mask.sum()), bool))
            if num_gt == 0:
                continue
            matched = np.zeros(len(entries), bool)
            for d, (s, i, box) in enumerate(entries):
                g_mask = np.asarray(ground_truths[i]["labels"]) == cls
                g_boxes = np.asarray(ground_truths[i]["boxes"],
                                     np.float64).reshape(-1, 4)[g_mask]
                if len(g_boxes) == 0:
                    continue
                ious = _iou_matrix(box[None], g_boxes)[0]
                order = np.argsort(-ious)
                for g in order:
                    if ious[g] < thr:
                        break
                    if not gt_taken[i][g]:
                        gt_taken[i][g] = True
                        matched[d] = True
                        break
            scores = np.asarray([e[0] for e in entries], np.float64)
            aps.append(average_precision(scores, matched, num_gt))
        if aps:
            per_class_ap[cls] = float(np.mean(aps))
    vals = list(per_class_ap.values())
    out = {"fixed_mAP": float(np.mean(vals)) if vals else float("nan")}
    if class_groups:
        for g in ("r", "c", "f"):
            gv = [ap for c, ap in per_class_ap.items()
                  if class_groups.get(c) == g]
            out[f"fixed_mAP_{g}"] = (float(np.mean(gv)) if gv
                                     else float("nan"))
    return out


# ---------------------------------------------------------------------------
# PASCAL VOC detection mAP
# ---------------------------------------------------------------------------
def voc_detection_map(predictions: Sequence[Dict],
                      ground_truths: Sequence[Dict],
                      iou_thresh: float = 0.5,
                      use_07_metric: bool = True) -> Dict:
    """PASCAL-VOC detection mAP with the reference's exact semantics
    (evaluation/voc/voc_eval.py:46-210, the chainercv-derived
    eval_detection_voc; do_voc_evaluation calls it with iou_thresh=0.5,
    use_07_metric=True at :28-33).

    predictions: per image {"boxes" (N,4) xyxy, "scores" (N,), "labels"}
    ground_truths: per image {"boxes", "labels", "difficult" (N,) bool}
    Returns {"ap": {class: ap}, "map": mean of finite APs}.

    Matching quirks preserved: boxes get +1 on their max corner before
    IoU ("VOC follows integer typed bounding boxes", :104-108); each
    detection's candidate GT is the argmax-IoU column computed over ALL
    class GTs at once (not greedy re-argmax, :113-116); a GT is burned
    (`selec[gt_idx] = True`) by EVERY detection whose argmax landed on it
    above threshold — including detections the difficult branch already
    absorbed (:116-126); difficult GTs turn their detections into
    "ignored" (-1) and are excluded from n_pos (:96, :119-126).
    """
    assert len(predictions) == len(ground_truths)
    n_pos: Dict[int, int] = {}
    cls_scores: Dict[int, List[np.ndarray]] = {}
    cls_match: Dict[int, List[np.ndarray]] = {}

    for pred, gt in zip(predictions, ground_truths):
        p_box = np.asarray(pred.get("boxes", np.zeros((0, 4))), np.float64)
        p_lbl = np.asarray(pred.get("labels", np.zeros((0,))), np.int64)
        p_scr = np.asarray(pred.get("scores", np.zeros((0,))), np.float64)
        g_box = np.asarray(gt.get("boxes", np.zeros((0, 4))), np.float64)
        g_lbl = np.asarray(gt.get("labels", np.zeros((0,))), np.int64)
        g_dif = np.asarray(gt.get("difficult",
                                  np.zeros(len(g_box), bool)), bool)
        for l in np.unique(np.concatenate([p_lbl, g_lbl]).astype(int)):
            sel_p = p_lbl == l
            order = np.argsort(-p_scr[sel_p])
            pb = p_box[sel_p][order]
            ps = p_scr[sel_p][order]
            sel_g = g_lbl == l
            gb = g_box[sel_g]
            gd = g_dif[sel_g]

            n_pos[l] = n_pos.get(l, 0) + int((~gd).sum())
            cls_scores.setdefault(l, []).append(ps)
            m = np.zeros(len(pb), np.int8)
            if len(pb) == 0:
                cls_match.setdefault(l, []).append(m)
                continue
            if len(gb) == 0:
                cls_match.setdefault(l, []).append(m)  # all zeros (FP)
                continue
            # VOC integer-box convention: +1 on the max corner
            # (:104-108) PLUS boxlist_iou's own TO_REMOVE=1 width pad
            # (structures/boxlist_ops.py:124-126) -> net +2
            pb1 = pb.copy()
            pb1[:, 2:] += 2
            gb1 = gb.copy()
            gb1[:, 2:] += 2
            iou = _iou_matrix(pb1, gb1)
            best = iou.argmax(axis=1)
            best[iou.max(axis=1) < iou_thresh] = -1
            claimed = np.zeros(len(gb), bool)
            for di, gi in enumerate(best):
                if gi >= 0:
                    if gd[gi]:
                        m[di] = -1
                    elif not claimed[gi]:
                        m[di] = 1
                    claimed[gi] = True
                # else m[di] stays 0
            cls_match.setdefault(l, []).append(m)

    ap: Dict[int, float] = {}
    for l, cnt in n_pos.items():
        scores = np.concatenate(cls_scores[l]) if cls_scores.get(l) \
            else np.zeros((0,))
        match = np.concatenate(cls_match[l]) if cls_match.get(l) \
            else np.zeros((0,), np.int8)
        order = np.argsort(-scores)
        match = match[order]
        tp = np.cumsum(match == 1)
        fp = np.cumsum(match == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = tp / (fp + tp)          # nan where fp+tp == 0
        if cnt <= 0:                       # rec is None -> AP = nan
            ap[l] = float("nan")
            continue
        rec = tp / cnt
        if use_07_metric:
            # 11-point interpolation (:189-196)
            a = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                keep = rec >= t
                p = np.max(np.nan_to_num(prec)[keep]) if keep.any() else 0.0
                a += p / 11.0
            ap[l] = float(a)
        else:
            # area under the monotone precision envelope (:197-210)
            mpre = np.concatenate([[0.0], np.nan_to_num(prec), [0.0]])
            mrec = np.concatenate([[0.0], rec, [1.0]])
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            step = np.where(mrec[1:] != mrec[:-1])[0]
            ap[l] = float(np.sum((mrec[step + 1] - mrec[step])
                                 * mpre[step + 1]))
    vals = np.asarray(list(ap.values()), np.float64)
    return {"ap": ap, "map": float(np.nanmean(vals)) if len(vals)
            else float("nan")}


# ---------------------------------------------------------------------------
# Classic LVIS AP (per-image cap + federated filtering + r/c/f groups)
# ---------------------------------------------------------------------------
def lvis_classic_eval(predictions: Sequence[Dict],
                      ground_truths: Sequence[Dict],
                      cat_frequencies: Dict[int, str],
                      max_dets: int = 300) -> Dict[str, float]:
    """The reference's standard LVISEval (lvis/lvis_eval.py:156-588):
    per-image detection cap (LVISResults.limit_dets_per_image, :137-149),
    federated-dataset filtering (:222-241: a detection of category c in
    image i only counts if c is in i's GT categories or its
    neg_category_ids; unmatched detections of not_exhaustive categories
    are ignored, :390-397), COCO-style greedy matching at IoU
    0.5:0.05:0.95, 101-point precision, and rare/common/frequent AP
    splits (:529-585).

    predictions: per image {"boxes" (N,4) xyxy, "scores", "labels"}
    ground_truths: per image {"boxes" xyxy, "labels",
        optional "areas", optional "ignore" (N,) ,
        "neg_category_ids": iterable, "not_exhaustive_category_ids": iterable}
    cat_frequencies: {category_id: "r"|"c"|"f"} — the full category
        vocabulary (absent categories still shape the AP means).
    Returns AP, AP50, AP75, APs/m/l, APr/c/f, AR@max_dets, ARs/m/l.
    """
    iou_thrs = np.linspace(0.5, 0.95, 10, endpoint=True)
    rec_thrs = np.linspace(0.0, 1.0, 101, endpoint=True)
    area_rngs = [(0.0, 1e10), (0.0, 32.0 ** 2),
                 (32.0 ** 2, 96.0 ** 2), (96.0 ** 2, 1e10)]
    area_lbls = ["all", "small", "medium", "large"]
    cat_ids = sorted(cat_frequencies)
    T, R, A = len(iou_thrs), len(rec_thrs), len(area_rngs)
    n_img = len(predictions)
    assert len(ground_truths) == n_img

    # --- per-image preparation: cap + federated filter ------------------
    # dts[img][cat] = (boxes, scores) sorted by -score (stable);
    # gts[img][cat] = (boxes, areas, ignore)
    dts: List[Dict[int, Tuple]] = []
    gts: List[Dict[int, Tuple]] = []
    nel: List[set] = []
    for pred, gt in zip(predictions, ground_truths):
        p_box = np.asarray(pred.get("boxes", np.zeros((0, 4))), np.float64)
        p_scr = np.asarray(pred.get("scores", np.zeros((0,))), np.float64)
        p_lbl = np.asarray(pred.get("labels", np.zeros((0,))), np.int64)
        if len(p_scr) > max_dets:          # :137-149
            keep = np.argsort(-p_scr, kind="stable")[:max_dets]
            p_box, p_scr, p_lbl = p_box[keep], p_scr[keep], p_lbl[keep]
        g_box = np.asarray(gt.get("boxes", np.zeros((0, 4))), np.float64)
        g_lbl = np.asarray(gt.get("labels", np.zeros((0,))), np.int64)
        g_area = np.asarray(gt.get("areas", (
            np.clip(g_box[:, 2] - g_box[:, 0], 0, None)
            * np.clip(g_box[:, 3] - g_box[:, 1], 0, None))), np.float64)
        g_ign = np.asarray(gt.get("ignore", np.zeros(len(g_box))),
                           np.int64)
        pos_cats = set(int(c) for c in g_lbl)
        neg_cats = set(int(c) for c in gt.get("neg_category_ids", ()))
        nel.append(set(int(c)
                       for c in gt.get("not_exhaustive_category_ids", ())))
        d, g = {}, {}
        for c in cat_ids:
            sel_g = g_lbl == c
            if sel_g.any():
                g[c] = (g_box[sel_g], g_area[sel_g], g_ign[sel_g])
            if c in pos_cats or c in neg_cats:      # federated keep (:239)
                sel_d = p_lbl == c
                if sel_d.any():
                    order = np.argsort(-p_scr[sel_d], kind="stable")
                    d[c] = (p_box[sel_d][order], p_scr[sel_d][order])
        dts.append(d)
        gts.append(g)

    precision = -np.ones((T, R, len(cat_ids), A))
    recall = -np.ones((T, len(cat_ids), A))

    for ci, c in enumerate(cat_ids):
        # evaluate_img per (area, img), then accumulate (:319-525)
        for ai, (a_lo, a_hi) in enumerate(area_rngs):
            all_scores, all_m, all_ig = [], [], []
            num_gt = 0
            for i in range(n_img):
                has_d = c in dts[i]
                has_g = c in gts[i]
                if not has_d and not has_g:
                    continue
                db, ds = dts[i].get(c, (np.zeros((0, 4)), np.zeros((0,))))
                gb, ga, gi0 = gts[i].get(
                    c, (np.zeros((0, 4)), np.zeros((0,)),
                        np.zeros((0,), np.int64)))
                g_ig = ((gi0 != 0) | (ga < a_lo) | (ga > a_hi)).astype(int)
                gt_order = np.argsort(g_ig, kind="stable")  # ignore last
                gb, g_ig = gb[gt_order], g_ig[gt_order]
                nD, nG = len(db), len(gb)
                ious = _iou_matrix(db, gb)
                dt_m = np.zeros((T, nD), bool)
                dt_ig = np.zeros((T, nD), bool)
                gt_m = np.zeros((T, nG), bool)
                for ti, thr in enumerate(iou_thrs):
                    if nG == 0:
                        break
                    for di in range(nD):
                        best = min(thr, 1.0 - 1e-10)
                        m = -1
                        for gix in range(nG):
                            if gt_m[ti, gix]:
                                continue
                            # matched a real gt already and the rest are
                            # ignore-gt: stop (:367-369)
                            if m > -1 and g_ig[m] == 0 and g_ig[gix] == 1:
                                break
                            if ious[di, gix] < best:
                                continue
                            best = ious[di, gix]
                            m = gix
                        if m == -1:
                            continue
                        dt_ig[ti, di] = bool(g_ig[m])
                        dt_m[ti, di] = True
                        gt_m[ti, m] = True
                # unmatched dt ignored when out of area range or in a
                # not-exhaustively-annotated category (:390-397)
                d_area = (np.clip(db[:, 2] - db[:, 0], 0, None)
                          * np.clip(db[:, 3] - db[:, 1], 0, None))
                d_mask = (d_area < a_lo) | (d_area > a_hi) | (c in nel[i])
                dt_ig |= (~dt_m) & d_mask[None, :]
                all_scores.append(ds)
                all_m.append(dt_m)
                all_ig.append(dt_ig)
                num_gt += int((g_ig == 0).sum())
            if num_gt == 0:
                continue
            scores = (np.concatenate(all_scores) if all_scores
                      else np.zeros((0,)))
            order = np.argsort(-scores, kind="stable")
            dm = (np.concatenate(all_m, axis=1)[:, order] if all_m
                  else np.zeros((T, 0), bool))
            dig = (np.concatenate(all_ig, axis=1)[:, order] if all_ig
                   else np.zeros((T, 0), bool))
            tps = dm & ~dig
            fps = ~dm & ~dig
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(T):
                tp, fp = tp_sum[ti], fp_sum[ti]
                rc = tp / num_gt
                recall[ti, ci, ai] = rc[-1] if len(tp) else 0.0
                pr = tp / (fp + tp + np.spacing(1))
                # monotone envelope from the right (:497-500)
                for k in range(len(pr) - 1, 0, -1):
                    if pr[k] > pr[k - 1]:
                        pr[k - 1] = pr[k]
                inds = np.searchsorted(rc, rec_thrs, side="left")
                pr_at = np.zeros(R)
                for ri, pi in enumerate(inds):
                    # the reference's bare `pr[pr_idx]` raises IndexError
                    # past the end and the surrounding try/except leaves
                    # the remaining entries 0.0 (:508-514); inds is
                    # nondecreasing so a break is exactly equivalent
                    if pi >= len(pr):
                        break
                    pr_at[ri] = pr[pi]
                precision[ti, :, ci, ai] = pr_at

    freq_idx = {g: [i for i, c in enumerate(cat_ids)
                    if cat_frequencies[c] == g] for g in ("r", "c", "f")}

    def _mean(s):
        v = s[s > -1]
        return float(v.mean()) if len(v) else -1.0

    def _ap(thr=None, area="all", freq=None):
        s = precision
        if thr is not None:
            s = s[np.where(np.isclose(iou_thrs, thr))[0]]
        s = s[:, :, freq_idx[freq], :] if freq else s
        return _mean(s[..., area_lbls.index(area)])

    def _ar(area="all"):
        return _mean(recall[..., area_lbls.index(area)])

    out = {"AP": _ap(), "AP50": _ap(0.5), "AP75": _ap(0.75),
           "APs": _ap(area="small"), "APm": _ap(area="medium"),
           "APl": _ap(area="large"),
           "APr": _ap(freq="r"), "APc": _ap(freq="c"), "APf": _ap(freq="f"),
           f"AR@{max_dets}": _ar()}
    for a in ("small", "medium", "large"):
        out[f"AR{a[0]}@{max_dets}"] = _ar(a)
    return out
