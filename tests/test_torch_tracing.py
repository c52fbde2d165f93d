"""The port's spans (`fiber_torch/utils/profiling.py::span`): free with no
profiler running, ordinary host events of a running profiler's trace,
and, in a tiny training step, detection call and rerank call on the CPU,
the hot paths' spans in order around unchanged outputs."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fiber_torch.config import FiberConfig
from fiber_torch.data.tokenizer import WhitespaceTokenizer
from fiber_torch.detection.detector import DetectorConfig, GroundingDetector
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.objectives.retrieval import rank_pairs_pipeline
from fiber_torch.tools.eval_det import TINY_CLASSES, predict_detections
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils.profiling import span, trace

torch.set_num_threads(1)
PREFIXES = ("train.", "det.", "rerank.")


def _host_spans(prof, prefixes=PREFIXES):
    """(name, start ns, end ns, is a user annotation) of the trace's
    events named by `prefixes`, outer before inner."""
    rows = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefixes)]
    return sorted(rows, key=lambda r: (r[1], -r[2]))


def test_span_without_a_profiler_is_one_shared_no_op():
    first = span("train.step")
    assert span("det.call") is first
    with first:
        with span("rerank.call") as inner:
            assert inner is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).add_(1)
    assert _host_spans(prof) == []
    assert span("train.step") is first


def test_spans_are_nested_host_events_not_annotations():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("train.step"):
            with span("train.forward"):
                torch.ones(4).mul_(2)
            with span("train.update"):
                torch.ones(4).add_(1)
    rows = _host_spans(prof)
    assert [r[0] for r in rows] == ["train.step", "train.forward",
                                    "train.update"]
    assert not any(r[3] for r in rows)
    (_, s0, e0, _), (_, s1, e1, _), (_, s2, e2, _) = rows
    assert s0 <= s1 < e1 <= s2 < e2 <= e0
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul_"]
    assert len(ops) == 1 and s1 <= ops[0].start_ns() <= e1
    assert span("train.step") is span("det.call")     # off again


def test_trace_exports_the_spans(tmp_path):
    """The operator's view: `trace(logdir)` writes the spans into its
    chrome trace, each around the operations it holds."""
    with trace(str(tmp_path / "tb")):
        with span("rerank.call"):
            torch.ones(8).mul_(3)
    (f,) = (tmp_path / "tb").glob("*.json")
    events = {e["name"]: e for e in json.loads(f.read_text())["traceEvents"]
              if e.get("ph") == "X"}
    outer, op = events["rerank.call"], events["aten::mul_"]
    assert outer["ts"] <= op["ts"]
    assert op["ts"] + op["dur"] <= outer["ts"] + outer["dur"]


def _pretrain_batch(cfg, B: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    S, L = cfg.image_size, cfg.max_text_len
    ids = rng.integers(4, cfg.vocab_size, (B, L))
    masks = np.ones((B, L), np.int64)
    masks[B // 2, L // 2:] = 0
    ids[masks == 0] = cfg.pad_token_id
    pick = (rng.random(ids.shape) < 0.15) & (masks == 1)
    pick[:, 1] = True
    return {"image": rng.standard_normal((B, S, S, 3)).astype(np.float32),
            "text_ids": ids, "text_masks": masks,
            "text_ids_mlm": np.where(pick, 3, ids),
            "text_labels_mlm": np.where(pick, ids, -100)}


def _train():
    cfg = FiberConfig.tiny_test(loss_names=("itm", "mlm", "itc"),
                                warmup_steps=0, learning_rate=1e-3)
    batch = _pretrain_batch(cfg, 2, seed=3)

    def run():
        tr = CoarseTrainer(cfg, device="cpu", seed=0)
        loss = tr.train_step(batch)["total_loss"]
        return [loss] + [p.detach().clone() for p in tr.params]
    return run, ["train.step", "train.forward", "train.backward",
                 "train.update"]


def _detect():
    model = GroundingDetector(DetectorConfig.tiny_test(), device="cpu",
                              seed=0).eval()
    H, W = model.cfg.image_size
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    sizes = np.tile(np.asarray([[H, W]], np.float32), (2, 1))
    tok = WhitespaceTokenizer()

    def run():
        out = predict_detections(model, images, sizes, TINY_CLASSES, tok,
                                 chunk_size=3, batch=2, pre_nms_thresh=0.0,
                                 pre_nms_top_n=100, post_nms_top_n=20)
        return [torch.from_numpy(np.asarray(d[k])) for d in out
                for k in ("boxes", "scores", "labels")]
    one_pass = ["det.pass", "det.stage", "det.stage", "det.forward",
                "det.head", "det.postprocess", "det.readback", "det.merge"]
    chunk = ["det.prompt"] + one_pass
    return run, ["det.call"] + chunk + chunk + ["det.merge"]


def _rerank():
    cfg = FiberConfig.tiny_test(loss_names=("itm", "mlm", "itc"))
    model = FiberCoarse(cfg, device="cpu", seed=0).eval()
    batch = _pretrain_batch(cfg, 4, seed=5)

    def run():
        return [rank_pairs_pipeline(
            model, batch["image"][:2], batch["text_ids"], batch["text_masks"],
            [0, 0, 1, 1], [0, 1, 2, 3], pair_batch=2, trunk_batch=2)]
    return run, ["rerank.call", "rerank.trunks", "rerank.text",
                 "rerank.pairs"]


@pytest.mark.parametrize("path", [_train, _detect, _rerank],
                         ids=["train_step", "predict_detections",
                              "rank_pairs_pipeline"])
def test_hot_path_spans_in_order_and_outputs_unchanged(path):
    run, want = path()
    plain = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run()
    rows = _host_spans(prof)
    assert [r[0] for r in rows] == want
    assert not any(r[3] for r in rows)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
