"""Zero-shot detection evaluation: a closed loop of
`fiber_torch.tools.eval_det.predict_detections` (the class vocabulary cut
into prompt chunks, one pass of the detector a chunk and batch, the ATSS
postprocess, the chunks' detections merged per image on the host), one
batch of images a call.

Set-up builds the served detector (bf16, eval), loads the run's weights,
stages a pool of images on the host as the evaluation tool takes them,
and warms a call; the window calls on, keeping every call's detections.
After the window the reference runs a sample of the calls, drawn from the
seed, and judges each detection the program reported: its box against
the reference's boxes at every anchor, its score against the reference's
score of its class at the anchor whose box it is, and each image's and
chunk's count of detections against the reference's postprocess.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import coarse, core, flops, traffic

# a detection's box is the reference's box of every anchor within this
# share of the box's longer side of the nearest one (the largest
# coordinate's distance): boxes clipped to the image's border coincide,
# and bf16 moves a box by up to 0.4% of its side
TIE = 0.01


def _names(tr) -> dict:
    return {int(k): v for k, v in tr["classes"].items()}


def _merged(ctx) -> dict:
    """The configuration's model and postprocess, and the chunk's class
    count, in one mapping."""
    return {**ctx.config["model"], **ctx.config["postprocess"],
            "chunk_classes": ctx.traffic["chunk_size"]}


def _call_images(n_pool: int, B: int, c: int) -> slice:
    """Call c's block of B images of the pool, as a slice: the tool gets
    a view, as a loader's batch, and makes its own copy."""
    lo = c % (n_pool // B) * B
    return slice(lo, lo + B)


def run(ctx) -> dict:
    m, tr, dev = _merged(ctx), ctx.traffic, ctx.device
    seeds = {k: core.derive(ctx.seed, k) for k in ("data", "sample")}
    images, sizes = traffic.detection_images(seeds["data"], m, tr, dev)
    tok = traffic.WordTokenizer(m["vocab_size"])
    if ctx.mode == "control":
        # the reference in float8 stands in the program's place
        ctx.start_window()
        n = tr["checked_calls"]
        fp8 = reference_model(ctx, control=True)
        outs = [reference_call(ctx, fp8, images, sizes, c, tok)[1]
                for c in range(n)]
        del fp8
        window = {"attempted": 0, "failed": 0, "rates": {}, "peak_bytes": 0,
                  "device": {}, "work": {}}
    else:
        outs, window = program(ctx, images, sizes, tok)
        n = len(outs)
    gen = torch.Generator().manual_seed(seeds["sample"])
    sample = torch.randperm(n, generator=gen)[:tr["checked_calls"]].tolist()
    model = reference_model(ctx)
    judged = [judge(outs[c], reference_call(ctx, model, images, sizes, c,
                                            tok)[0], m) for c in sample]
    cat = {k: torch.cat([j[k] for j in judged]) for k in
           ("score", "ref_score", "box")}
    err = cat["score"] - cat["ref_score"]
    readings = {
        "score_gap": float(err.abs().max()),
        "score_rms": float(err.pow(2).mean().sqrt() / cat["ref_score"].std()),
        "box_gap": float(cat["box"].max()),
        "box_rms": float(cat["box"].pow(2).mean().sqrt()),
        "count_gap": max(j["count_gap"] for j in judged)}
    return dict(window, readings=readings)


def program(ctx, images, sizes, tok):
    """Every call's detections and the window."""
    from fiber_torch.detection.detector import GroundingDetector
    from fiber_torch.tools.eval_det import predict_detections

    m, tr, dev = _merged(ctx), ctx.traffic, ctx.device
    model = GroundingDetector(program_config(ctx.config), device=dev,
                              seed=core.derive(ctx.seed, "program"))
    model.load_state_dict(coarse.weights_of(ctx.config, detector_shapes(
        ctx.config), ctx.seed, dev))
    names, B = _names(tr), tr["batch"]
    spans = Spans(model) if ctx.trace.enabled else None

    def call(c: int) -> list:
        idx = _call_images(len(images), B, c)
        return predict_detections(model, images[idx], sizes[idx], names, tok,
                                  chunk_size=tr["chunk_size"], batch=B,
                                  **ctx.config["postprocess"])

    call(0)
    if dev != "cpu":
        torch.cuda.synchronize()
    ctx.start_window()
    outs = []
    with ctx.trace:
        if spans:
            spans.on()
        t0 = time.perf_counter()
        while True:
            outs.append(call(len(outs)))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if dev != "cpu":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    n = len(outs)
    failed = sum(not all(np.isfinite(d[k]).all() for k in ("boxes", "scores"))
                 for o in outs for d in o)
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    device = {}
    if dev != "cpu":
        from portbench.harness.runner import device_info
        device = device_info(ctx.cell["chips"], peak)
    work = {}
    if spans:
        work = spans.off()
    del model
    if dev != "cpu":
        torch.cuda.empty_cache()
    passes = n * len(range(0, len(names), tr["chunk_size"]))
    work.update(model_flops=passes * B * flops.detect_pass_flops(m),
                k1=flops.detect_pass_launches(m, B) * passes)
    return outs, {"attempted": n * B, "failed": failed,
                  "rates": {"det_images_per_s": n * B / elapsed},
                  "peak_bytes": peak, "device": device, "work": work}


class Spans:
    """Device time of the fusion backbone and of the head in each pass,
    between CUDA events that forward hooks on the program's two modules
    record (only while on)."""

    def __init__(self, model):
        self.mods = {"backbone": model.fusion_backbone,
                     "head": model.rpn["head"]}
        self.events = {k: [] for k in self.mods}
        self.handles = []

    def on(self) -> None:
        for k, mod in self.mods.items():
            def pre(_m, _a, k=k):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events[k].append([e])

            def post(_m, _a, _o, k=k):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events[k][-1].append(e)

            self.handles += [mod.register_forward_pre_hook(pre),
                             mod.register_forward_hook(post)]

    def off(self) -> dict:
        for h in self.handles:
            h.remove()
        torch.cuda.synchronize()
        return {f"{k}_ms": [a.elapsed_time(b) for a, b in ev]
                for k, ev in self.events.items()}


def program_config(config):
    from fiber_torch.detection.detector import DetectorConfig
    import dataclasses
    fields = {f.name for f in dataclasses.fields(DetectorConfig)}
    vals = {k: tuple(v) if isinstance(v, list) else v
            for k, v in config["model"].items() if k in fields}
    return DetectorConfig(**vals, compute_dtype=coarse.DTYPES[
        config["numerics"]["compute_dtype"]])


def detector_shapes(config) -> dict:
    from portbench.reference.detector import GroundingDetector
    model = GroundingDetector(config["model"], "meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def reference_model(ctx, control: bool = False):
    """The reference detector on the served weights, fp32 (TF32 off), or
    with float8 linears and convolutions for the control."""
    from portbench.reference import detector, layers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    num = ctx.config["numerics"]
    model = detector.GroundingDetector(ctx.config["model"], ctx.device)
    model.load_state_dict(core.served(
        coarse.weights_of(ctx.config, detector_shapes(ctx.config), ctx.seed,
                          ctx.device),
        coarse.DTYPES[num["compute_dtype"]], num["keep_fp32"]))
    return layers.use_fp8(model) if control else model


@torch.no_grad()
def reference_call(ctx, model, images, sizes, c: int, tok):
    """The reference's dense scores and boxes, and its own detections (in
    the program's format), of call c, chunk by chunk."""
    from portbench.reference import detector
    m, tr, dev = _merged(ctx), ctx.traffic, ctx.device
    names, B = _names(tr), tr["batch"]
    idx = _call_images(len(images), B, c)
    img = torch.from_numpy(images[idx]).to(dev)
    size = torch.from_numpy(sizes[idx]).to(dev)
    per_chunk, dets = [], [{"boxes": [], "scores": [], "labels": []}
                           for _ in range(B)]
    for chunk in detector.chunks(names, tr["chunk_size"]):
        caption, agg = detector.prompt(names, chunk, tok, m["max_query_len"])
        enc = tok.batch([caption] * B, max_length=m["max_query_len"])
        head = model(img, torch.from_numpy(enc["input_ids"]).long().to(dev),
                     torch.from_numpy(enc["attention_mask"]).long().to(dev))
        levels = detector.dense(head, m, torch.from_numpy(agg).to(dev), size)
        kept = detector.postprocess(levels, m)
        per_chunk.append({"chunk": chunk, "levels": levels,
                          "count": kept["valid"].sum(1).tolist()})
        for j in range(B):
            v = kept["valid"][j]
            dets[j]["boxes"].append(kept["boxes"][j][v].cpu().numpy())
            dets[j]["scores"].append(kept["scores"][j][v].cpu().numpy())
            dets[j]["labels"].append(np.asarray(
                [chunk[int(l) - 1] for l in kept["labels"][j][v]], np.int64))
    return per_chunk, [{k: np.concatenate(v) for k, v in d.items()}
                       for d in dets]


def judge(dets: list, ref: list, m) -> dict:
    """One call's detections judged: each one's score and the reference's
    score of its class at the anchor whose box it is (of the anchors whose
    boxes lie as near, the nearest score), each one's box distance (the
    largest coordinate's distance over the reference box's longer side,
    at least a pixel), and the largest relative gap between an image's and
    chunk's count of detections and the reference's."""
    scores, ref_scores, dists, count_gap = [], [], [], 0.0
    for r in ref:
        chunk = {l: i for i, l in enumerate(r["chunk"])}
        boxes = torch.cat([lv["boxes"] for lv in r["levels"]], 1)  # (B, A, 4)
        score = torch.cat([lv["score"] for lv in r["levels"]], 1)  # (B, A, C)
        for j, d in enumerate(dets):
            mine = np.isin(d["labels"], list(chunk))
            want = r["count"][j]
            count_gap = max(count_gap, abs(int(mine.sum()) - want) / max(want, 1))
            if not mine.any():
                continue
            b = torch.from_numpy(d["boxes"][mine]).float().to(boxes.device)
            s = torch.from_numpy(d["scores"][mine]).float().to(boxes.device)
            c = torch.tensor([chunk[int(l)] for l in d["labels"][mine]],
                             device=boxes.device)
            dist = (b[:, None, :] - boxes[j][None]).abs().amax(-1)   # (n, A)
            near, at = dist.min(1)
            side = (boxes[j][at, 2:] - boxes[j][at, :2]).amax(-1).clamp_min(1.0)
            ties = dist <= (near + TIE * side)[:, None]
            ref_s = score[j][:, c].T                                  # (n, A)
            pick = torch.where(ties, (ref_s - s[:, None]).abs(),
                               torch.full_like(ref_s, torch.inf)).argmin(1)
            scores.append(s)
            ref_scores.append(ref_s.gather(1, pick[:, None])[:, 0])
            dists.append(near / side)
    empty = torch.zeros(0)
    return {"score": torch.cat(scores).cpu() if scores else empty,
            "ref_score": torch.cat(ref_scores).cpu() if scores else empty,
            "box": torch.cat(dists).cpu() if dists else empty,
            "count_gap": count_gap}
