"""ITM rerank: a closed loop of `rank_pairs_pipeline` (image trunks, text
prefixes, the fused tail and the rank head over every pair), one block of
an image-to-text rerank a call.

Set-up builds the served model (bf16, eval), loads the run's weights,
draws the corpus and every call's candidates, and warms the call's
shapes; the window calls on, the scores of every call kept on the device.
After the window the reference scores a sample of the calls, drawn from
the seed, and the run compares every score of the sample: each image
query's root-mean-square gap over its candidates, the worst query's over
the spread (standard deviation) of the reference's scores (`query_rms`).
"""

from __future__ import annotations

import time

import torch

from portbench.harness import coarse, core, flops, traffic

# pairs the reference scores at a time: its fp32 activations of a block
# of the program's pair batch would not fit beside its weights
REF_PAIRS = 128


def run(ctx) -> dict:
    cfg_file, tr, dev = ctx.config, ctx.traffic, ctx.device
    m = cfg_file["model"]
    seeds = {k: core.derive(ctx.seed, k) for k in ("data", "sample")}
    corpus = traffic.rerank_corpus(
        seeds["data"], m, tr,
        coarse.DTYPES[cfg_file["numerics"]["compute_dtype"]], dev)
    if ctx.mode == "control":
        # the reference in float8 stands in the program's place
        ctx.start_window()
        n = tr["checked_calls"]
        scores = list(reference_scores(ctx, corpus, range(n), control=True))
        window = {"attempted": 0, "failed": 0, "rates": {}, "peak_bytes": 0,
                  "device": {}, "work": {}}
    else:
        scores, window = program(ctx, corpus)
        n = len(scores)
    gen = torch.Generator().manual_seed(seeds["sample"])
    sample = torch.randperm(n, generator=gen)[:tr["checked_calls"]].tolist()
    got = torch.stack([scores[c] for c in sample]).float()
    want = reference_scores(ctx, corpus, sample)
    err = got - want
    per_query = err.reshape(-1, tr["candidates"]).pow(2).mean(1).sqrt()
    return dict(window, readings={
        "query_rms": float(per_query.max() / want.std()),
        "score_rms": float(err.pow(2).mean().sqrt() / want.std()),
        "score_gap": float(err.abs().max() / want.abs().max())})


def program(ctx, corpus):
    """Every call's scores (kept on the device) and the window."""
    from fiber_torch.models.fiber import FiberCoarse
    from fiber_torch.objectives.retrieval import rank_pairs_pipeline

    cfg_file, tr, dev = ctx.config, ctx.traffic, ctx.device
    m = cfg_file["model"]
    cfg = coarse.program_config(cfg_file)
    model = FiberCoarse(cfg, device=dev,
                        seed=core.derive(ctx.seed, "program")).eval()
    model.load_state_dict(coarse.weights(cfg_file, ctx.seed, dev))

    def call(c: int) -> torch.Tensor:
        x = traffic.rerank_call(corpus, tr, c)
        return rank_pairs_pipeline(model, x["images"], x["text_ids"],
                                   x["text_masks"], x["pair_img"],
                                   x["pair_txt"], tr["pair_batch"],
                                   tr["trunk_batch"])

    call(0)
    if dev != "cpu":
        torch.cuda.synchronize()

    ctx.start_window()
    scores = []
    with ctx.trace:
        t0 = time.perf_counter()
        while True:
            scores.append(call(len(scores)))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if dev != "cpu":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    n = len(scores)
    pairs = tr["images"] * tr["candidates"]
    failed = int((~torch.isfinite(torch.stack(scores))).sum())
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    device = {}
    if dev != "cpu":
        from portbench.harness.runner import device_info
        device = device_info(ctx.cell["chips"], peak)
    del model
    if dev != "cpu":
        torch.cuda.empty_cache()
    launches = flops.rerank_call_launches(m, tr["images"], tr["trunk_batch"],
                                          pairs, tr["pair_batch"])
    return scores, {
        "attempted": n * pairs, "failed": failed,
        "rates": {"rerank_pairs_per_s": n * pairs / elapsed},
        "peak_bytes": peak, "device": device,
        "work": {"model_flops": n * flops.rerank_call_flops(
                     m, tr["images"], pairs, pairs),
                 "k1": launches * n}}


@torch.no_grad()
def reference_scores(ctx, corpus, calls, control: bool = False
                     ) -> torch.Tensor:
    """(len(calls), pairs) rank scores of the reference, fp32 (TF32 off)
    on the served weights, or float8 linears and convolutions for the
    control; a call's trunks, then its text prefixes and fused tails
    `REF_PAIRS` pairs at a time."""
    from portbench.reference import layers
    dev, tr = ctx.device, ctx.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    num = ctx.config["numerics"]
    model = coarse.reference_model(ctx.config, dev)
    model.load_state_dict(core.served(
        coarse.weights(ctx.config, ctx.seed, dev),
        coarse.DTYPES[num["compute_dtype"]], num["keep_fp32"]))
    if control:
        layers.use_fp8(model)
    model.eval()
    out = []
    for c in calls:
        x = traffic.rerank_call(corpus, tr, c)
        trunks = model.encode_image_trunk(x["images"].float())
        scores = []
        for lo in range(0, x["pair_img"].shape[0], REF_PAIRS):
            pi = x["pair_img"][lo:lo + REF_PAIRS]
            pt = x["pair_txt"][lo:lo + REF_PAIRS]
            ids, masks = x["text_ids"][pt], x["text_masks"][pt]
            text = model.encode_text_pre(ids, masks)
            tail = model.infer_fused_tail(trunks[pi], text, masks)
            scores.append(model.rank_scores(tail["cls_feats"])[:, 0])
        out.append(torch.cat(scores))
    return torch.stack(out)
