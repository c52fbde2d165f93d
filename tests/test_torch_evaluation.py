"""The port's evaluators against their `fiber_tpu.detection.evaluation`
twins on seeded synthetic predictions, exactly equal: crowd, ignore and
difficult ground truths, empty images, tied scores, several refexp
datasets, the LVIS frequency groups and federated lists; and
`render_detections` against JAX's, pixel for pixel."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_tpu.detection import demo as jax_demo
from fiber_tpu.detection import evaluation as jev
from fiber_torch.detection import demo
from fiber_torch.detection import evaluation as ev
from fiber_torch.train import metrics

torch.set_num_threads(1)

SEEDS = (0, 1, 2)


def assert_same(a, b, path="out"):
    """Equal structure and values; floats bit-equal or both NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (np.ndarray, np.generic)) and np.ndim(a):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), path
        assert (math.isnan(a) and math.isnan(b)) or a == b, (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _boxes(rng, n, canvas=200.0, lo=4.0, hi=120.0):
    xy = rng.uniform(0, canvas - hi, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _near(rng, gt, n, jitter=6.0):
    """n detections around random ground-truth boxes (some hits)."""
    if len(gt) == 0:
        return _boxes(rng, n)
    pick = rng.integers(0, len(gt), n)
    d = gt[pick] + rng.normal(0, jitter, (n, 4))
    d[:, 2:] = np.maximum(d[:, 2:], d[:, :2] + 1.0)
    return d


def dataset(seed, n_img=6, n_cls=5, tie=True):
    """Predictions and ground truths: crowd and ignore flags, difficult
    boxes, an image with no detections and one with no ground truth,
    scores on a 0.1 grid (ties) when `tie`."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(n_img):
        g = 0 if i == n_img - 1 else int(rng.integers(1, 6))
        gb = _boxes(rng, g)
        gl = rng.integers(1, n_cls + 1, g)
        nd = 0 if i == 1 else int(rng.integers(3, 12))
        db = np.concatenate([_near(rng, gb, nd - nd // 3),
                             _boxes(rng, nd // 3)]) if nd else \
            np.zeros((0, 4))
        dl = np.concatenate([gl[rng.integers(0, g, nd - nd // 3)] if g
                             else rng.integers(1, n_cls + 1, nd - nd // 3),
                             rng.integers(1, n_cls + 1, nd // 3)]) if nd \
            else np.zeros((0,), np.int64)
        s = rng.uniform(0.05, 1.0, nd)
        if tie:
            s = np.round(s, 1)
        preds.append({"boxes": db, "scores": s, "labels": dl})
        gts.append({"boxes": gb, "labels": gl,
                    "iscrowd": rng.random(g) < 0.15,
                    "ignore": (rng.random(g) < 0.15).astype(np.int64),
                    "difficult": rng.random(g) < 0.2,
                    "neg_category_ids": [int(c) for c in
                                         rng.integers(1, n_cls + 1, 2)],
                    "not_exhaustive_category_ids": [int(rng.integers(
                        1, n_cls + 1))]})
    return preds, gts


@pytest.mark.parametrize("seed", SEEDS)
def test_iou_matrices_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    for name in ("_iou_matrix", "_giou_matrix", "_legacy_iou_matrix"):
        assert_same(getattr(ev, name)(a, b), getattr(jev, name)(a, b), name)
    assert_same(ev._giou_matrix(a[:0], b), jev._giou_matrix(a[:0], b))


@pytest.mark.parametrize("seed", SEEDS)
def test_match_detections_and_average_precision_match_jax(seed):
    preds, gts = dataset(seed)
    for p, g in zip(preds, gts):
        for thr in (0.3, 0.5, 0.75):
            m = ev.match_detections(p["boxes"], p["scores"], g["boxes"], thr)
            assert_same(m, jev.match_detections(p["boxes"], p["scores"],
                                                g["boxes"], thr))
            assert_same(ev.average_precision(p["scores"], m, len(g["boxes"])),
                        jev.average_precision(p["scores"], m,
                                              len(g["boxes"])))


@pytest.mark.parametrize("seed", SEEDS)
def test_coco_map_with_crowd_matches_jax(seed):
    preds, gts = dataset(seed)
    assert_same(ev.coco_map(preds, gts), jev.coco_map(preds, gts))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("legacy", (True, False))
def test_box_proposal_ar_matches_jax(seed, legacy):
    preds, gts = dataset(seed)
    for area in ("all", "small", "medium", "large", "96-128"):
        for limit in (None, 3):
            kw = dict(area=area, limit=limit, legacy_plus_one=legacy)
            assert_same(ev.box_proposal_ar(preds, gts, **kw),
                        jev.box_proposal_ar(preds, gts, **kw), str(kw))


def _phrases(seed, n=12):
    """One entry a phrase: score-sorted boxes; a phrase with no boxes
    predicted and one with no ground truth."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(n):
        g = _boxes(rng, 0 if i == 3 else int(rng.integers(1, 4)))
        p = _near(rng, g, 0 if i == 5 else int(rng.integers(1, 12)), 15.0)
        preds.append({"boxes": p})
        gts.append({"boxes": g})
    return preds, gts


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("merge", (False, True))
def test_flickr_grounding_recall_matches_jax(seed, merge):
    preds, gts = _phrases(seed)
    kw = dict(ks=(1, 5, 10, -1), merge_boxes=merge)
    assert_same(ev.flickr_grounding_recall(preds, gts, **kw),
                jev.flickr_grounding_recall(preds, gts, **kw))


def _referrals(seed, n=15):
    """Referrals over three dataset names (one row with none, taking the
    default name), tied scores, a row with no boxes."""
    rng = np.random.default_rng(seed)
    names = ("refcoco", "refcoco+", "refcocog")
    preds, gts = [], []
    for i in range(n):
        g = _boxes(rng, 1)
        k = 0 if i == 4 else int(rng.integers(1, 10))
        preds.append({"boxes": _near(rng, g, k, 20.0),
                      "scores": np.round(rng.uniform(0, 1, k), 1)})
        gt = {"boxes": g}
        if i != 7:
            gt["dataset_name"] = names[i % 3]
        gts.append(gt)
    return preds, gts


@pytest.mark.parametrize("seed", SEEDS)
def test_refexp_precision_and_accuracy_match_jax(seed):
    preds, gts = _referrals(seed)
    out = ev.refexp_precision(preds, gts)
    assert_same(out, jev.refexp_precision(preds, gts))
    assert {"P@1_refcoco", "P@5_refcoco+", "P@10_refcocog",
            "P@1_refexp"} <= set(out)
    assert_same(ev.refexp_precision(preds, gts, ks=(1, 3), thresh_iou=0.3),
                jev.refexp_precision(preds, gts, ks=(1, 3), thresh_iou=0.3))
    assert_same(ev.refexp_accuracy(preds, gts),
                jev.refexp_accuracy(preds, gts))


GROUPS = {1: "r", 2: "c", 3: "f", 4: "f", 5: "c", 6: "r"}


@pytest.mark.parametrize("seed", SEEDS)
def test_lvis_fixed_ap_matches_jax(seed):
    preds, gts = dataset(seed)
    for kw in (dict(), dict(class_groups=GROUPS),
               dict(dets_per_class=4, class_groups=GROUPS)):
        assert_same(ev.lvis_fixed_ap(preds, gts, **kw),
                    jev.lvis_fixed_ap(preds, gts, **kw), str(kw))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("use_07", (True, False))
def test_voc_detection_map_matches_jax(seed, use_07):
    preds, gts = dataset(seed)
    for thr in (0.5, 0.7):
        out = ev.voc_detection_map(preds, gts, iou_thresh=thr,
                                   use_07_metric=use_07)
        assert_same(out, jev.voc_detection_map(preds, gts, iou_thresh=thr,
                                               use_07_metric=use_07))


@pytest.mark.parametrize("seed", SEEDS)
def test_lvis_classic_eval_matches_jax(seed):
    """Frequency groups over a vocabulary wider than the data (an absent
    category, a group with no ground truth), the federated negative and
    not-exhaustive lists, ignore flags, and a per-image cap that cuts."""
    preds, gts = dataset(seed)
    freq = dict(GROUPS)
    freq[7] = "r"
    for max_dets in (300, 4):
        out = ev.lvis_classic_eval(preds, gts, freq, max_dets=max_dets)
        assert_same(out, jev.lvis_classic_eval(preds, gts, freq,
                                               max_dets=max_dets))
    areas = [dict(g, areas=np.full(len(g["boxes"]), 2000.0)) for g in gts]
    assert_same(ev.lvis_classic_eval(preds, areas, freq),
                jev.lvis_classic_eval(preds, areas, freq))


def test_ground_truth_as_detections_scores_one():
    """The control the card's evaluator phase runs: ground truths fed back
    as detections at score 1 give 1.0 in both packages wherever JAX's
    does."""
    _, gts = dataset(3, tie=False)
    gts = [dict(g, iscrowd=np.zeros(len(g["boxes"]), bool),
                ignore=np.zeros(len(g["boxes"]), np.int64),
                difficult=np.zeros(len(g["boxes"]), bool)) for g in gts]
    preds = [{"boxes": g["boxes"], "labels": g["labels"],
              "scores": np.ones(len(g["boxes"]))} for g in gts]
    assert_same(ev.voc_detection_map(preds, gts),
                jev.voc_detection_map(preds, gts))
    # the 07 metric sums eleven 1/11 steps: 1 + 2.2e-16 in both packages
    assert ev.voc_detection_map(preds, gts)["map"] == pytest.approx(
        1.0, abs=1e-12)
    freq = {c: "f" for c in range(1, 6)}
    got = ev.lvis_classic_eval(preds, gts, freq)
    assert_same(got, jev.lvis_classic_eval(preds, gts, freq))
    assert got["AP"] == 1.0
    assert ev.lvis_fixed_ap(preds, gts)["fixed_mAP"] == 1.0
    assert ev.box_proposal_ar(preds, gts)["ar"] == 1.0


def test_check_expected_results_is_the_trainers():
    assert ev.check_expected_results is metrics.check_expected_results
    m = {"AP": 0.5, "AP50": 0.7}
    exp = [("AP", 0.5, 0.01), ("AP50", 0.5, 0.1), ("APs", 0.1, 0.1)]
    assert ev.check_expected_results(m, exp) == \
        jev.check_expected_results(m, exp)


@pytest.mark.parametrize("with_masks", (False, True))
def test_render_detections_matches_jax(with_masks):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (48, 64, 3), np.uint8)
    boxes = np.asarray([[5., 5., 25., 15.], [20., 10., 60., 40.],
                        [0., 30., 10., 47.]])
    labels = ["dog", "red car", "a"]
    masks = None
    if with_masks:
        masks = rng.random((3, 48, 64)) < 0.3
    for scores in (None, np.asarray([0.9, 0.456, 0.1])):
        got = demo.render_detections(img, boxes, labels, scores=scores,
                                     masks=masks, width=3)
        want = jax_demo.render_detections(img, boxes, labels, scores=scores,
                                          masks=masks, width=3)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()


def _card_phase():
    """chip_smoke.py's evaluator phase (phase 51) helpers; the script
    imports only the port."""
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def test_card_phase_suite_matches_jax():
    """The card's evaluator phase on its own ground truths, with seeded
    detections in place of the model's (40 an image, float32, as
    `predict_detections` gives them): the port's suite equals JAX's,
    every metric in [0, 1]; the ground truths fed back at score 1 give
    1.0 at every metric in JAX's evaluators, as the phase asserts."""
    cs = _card_phase()
    gts = cs.evaluator_gts(cs.DDP_EVAL_IMAGES, cs.SEED + 13)
    freq = cs.lvis_frequencies(cs.SEED + 14)
    assert len(freq) == 1203 and {freq[c] for c in range(1, 11)} == \
        {"r", "c", "f"}
    rng = np.random.default_rng(5)
    preds = []
    for g in gts:
        boxes = np.concatenate([_near(rng, g["boxes"], 30, 10.0),
                                _boxes(rng, 10, 800.0, 10.0, 300.0)])
        preds.append({"boxes": boxes.astype(np.float32),
                      "scores": rng.random(40).astype(np.float32),
                      "labels": rng.integers(1, 11, 40)})
    port, _ = cs.evaluator_suite(ev, preds, gts, freq)
    assert_same(port, cs.evaluator_suite(jev, preds, gts, freq)[0])
    vals = cs.flat_metrics(port)
    assert len(vals) == 56
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in vals.values())
    control = cs.ground_truth_control(gts)
    jax_ctrl = cs.evaluator_suite(jev, control, gts, freq)[0]
    assert_same(cs.evaluator_suite(ev, control, gts, freq)[0], jax_ctrl)
    ones = cs.flat_metrics(jax_ctrl)
    assert set(ones) == set(vals)
    assert all(abs(v - 1.0) <= cs.CONTROL_ATOL for v in ones.values())
