"""The detection port's host-side pieces against the JAX package's on
fixtures: the grounding prompts and token maps (`od_to_grounding`), COCO
mAP on seeded predictions, the noun-phrase chunker; and the evaluation
tool as a user runs it, on the CPU at tiny dims."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_tpu.data import od_to_grounding as jax_odg
from fiber_tpu.data.tokenizer import WhitespaceTokenizer as JaxTokenizer
from fiber_tpu.detection import demo as jax_demo
from fiber_tpu.detection.evaluation import coco_map as jax_coco_map
from fiber_torch.data import od_to_grounding as odg
from fiber_torch.data.tokenizer import WhitespaceTokenizer
from fiber_torch.detection import demo
from fiber_torch.detection.evaluation import coco_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NAMES = {1: "person", 2: "bicycle", 3: "traffic light", 4: "dog", 5: "car",
         6: "fire hydrant", 7: "stop sign"}


def test_detection_prompt_and_maps_match_jax():
    """The same prompts (positives, sampled negatives, shuffled), token
    maps and positive maps from the same seed and tokenizer state."""
    for seed, present, neg, shuffle in ((0, [2, 5], 3, True),
                                        (1, [1], 85, False),
                                        (2, [3, 6, 7], 0, True)):
        p = odg.build_detection_prompt(NAMES, present, num_negatives=neg,
                                       rng=np.random.default_rng(seed),
                                       shuffle=shuffle)
        q = jax_odg.build_detection_prompt(NAMES, present,
                                           num_negatives=neg,
                                           rng=np.random.default_rng(seed),
                                           shuffle=shuffle)
        assert (p.caption, p.label_spans) == (q.caption, q.label_spans)
        tok, jtok = WhitespaceTokenizer(), JaxTokenizer()
        for max_len in (6, 64):
            assert odg.build_label_to_token_map(tok, p, max_len) == \
                jax_odg.build_label_to_token_map(jtok, q, max_len)
            spans = list(p.label_spans.values())
            np.testing.assert_array_equal(
                odg.build_positive_map(tok, p.caption, spans, max_len),
                jax_odg.build_positive_map(jtok, q.caption, spans, max_len))
            assert odg.check_for_positive_overflow(p, tok, present, max_len) \
                == jax_odg.check_for_positive_overflow(q, jtok, present,
                                                       max_len)
    for size in (1, 3, 40):
        assert odg.chunk_class_names(NAMES, size) == \
            jax_odg.chunk_class_names(NAMES, size)


def seeded_detections(seed: int, n_img: int = 6, n_cls: int = 4):
    """Predictions and ground truths: jittered copies of the ground truth
    boxes among random ones, crowd boxes, boxes of every area range, an
    image without ground truth and one without predictions."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(n_img):
        g = rng.integers(1, 5)
        xy = rng.uniform(0, 300, (g, 2))
        wh = rng.choice([12.0, 50.0, 150.0], (g, 1)) * rng.uniform(
            0.8, 1.2, (g, 2))
        gb = np.concatenate([xy, xy + wh], 1)
        gl = rng.integers(1, n_cls + 1, g)
        crowd = rng.uniform(0, 1, g) < 0.15
        d = rng.integers(0, 12)
        near = rng.integers(0, g, d)
        jit = gb[near] + rng.normal(0, 6, (d, 4))
        rand = np.concatenate([rng.uniform(0, 300, (d, 2))] * 2, 1)
        rand[:, 2:] += rng.uniform(5, 120, (d, 2))
        is_jit = rng.uniform(0, 1, d) < 0.6
        pred = {"boxes": np.where(is_jit[:, None], jit, rand),
                "scores": rng.uniform(0, 1, d),
                "labels": np.where(is_jit, gl[near],
                                   rng.integers(1, n_cls + 1, d))}
        gt = {"boxes": gb, "labels": gl, "iscrowd": crowd}
        if i == 0:
            gt = {"boxes": np.zeros((0, 4)), "labels": np.zeros(0, int)}
        if i == 1:
            pred = {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                    "labels": np.zeros(0, int)}
        preds.append(pred)
        gts.append(gt)
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_map_matches_jax(seed):
    preds, gts = seeded_detections(seed)
    for kw in ({}, {"max_dets": (1, 5, 20)}):
        got, want = coco_map(preds, gts, **kw), jax_coco_map(preds, gts, **kw)
        assert got.keys() == want.keys()
        for k in want:
            assert (math.isnan(got[k]) and math.isnan(want[k])) \
                or got[k] == want[k], k
    assert 0 < coco_map(preds, gts)["mAP"] < 1


CAPTIONS = ("A man in a red shirt is riding a bike next to the old car.",
            "two dogs chasing a ball on the beach, and a cat",
            "The bus", "")


def test_noun_phrase_chunker_matches_jax(monkeypatch):
    """The closed-class chunker, which both packages use where NLTK's
    models are not installed (NLTK itself made unimportable here: its
    import is slow, and this host has no models for it)."""
    monkeypatch.setitem(sys.modules, "nltk", None)
    for caption in CAPTIONS:
        assert demo.find_noun_phrases(caption) == \
            jax_demo.find_noun_phrases(caption)
        assert demo.run_ner(caption) == jax_demo.run_ner(caption)
    assert demo.run_ner("a cat", refexp_mode=True) == [[(0, 5)]]


def test_eval_det_tool_runs_on_the_cpu():
    """`python -m fiber_torch.tools.eval_det --tiny --device cpu` prints the
    metrics: every key, finite where the ground truths give one (COCO's nan
    marks an area range without ground truth).  The tool runs as its
    `__main__`, with transformers made unimportable as on the card's
    machine (its whitespace tokenizer then; and the import is slow)."""
    argv = ["eval_det", "--tiny", "--device", "cpu", "--num-images", "2",
            "--chunk-size", "3"]
    code = ("import runpy, sys\n"
            "sys.modules['transformers'] = None\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('fiber_torch.tools.eval_det', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    metrics = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(metrics) == {"mAP", "AP50", "AP75", "APs", "APm", "APl",
                            "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"}
    # the tool's ground-truth box, 36 x 36, is a medium one
    for k in ("mAP", "AP50", "AP75", "APm", "AR1", "AR10", "AR100", "ARm"):
        assert math.isfinite(metrics[k]), k
