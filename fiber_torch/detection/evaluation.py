"""COCO-style detection AP / AR (host side, numpy).

The port's copy of `coco_map` and its helpers from
`fiber_tpu/detection/evaluation.py`: COCOeval semantics (greedy per-(image,
class) matching at 10 IoU thresholds with crowd / ignore handling, 101-point
interpolated precision, the area-range APs / APm / APl and AR@{1,10,100}),
for bbox, segm (rasterised masks) and keypoint (OKS) IoU types.  The
regression assert `check_expected_results` is in
`fiber_torch/train/metrics.py`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

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
