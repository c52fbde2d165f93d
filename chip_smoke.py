"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the port's CUDA kernels from `fiber_torch/csrc/`;
3. K1 (window attention) against its plain PyTorch version on the card at
   every FIBER-Base 384^2 stage shape, fp32 (TF32 off) and bf16, with
   kernel, plain and library (SDPA) times and the card's bound;
4. the main path: FIBER-Base 384^2 bf16 ITM rerank (`itm_rerank_matrix` ->
   `rank_pairs_pipeline`) on seeded weights with non-zero fusion gates,
   4 images x 8 texts; the launch count shows the kernel ran in every Swin
   block, and the cached scores are held against the full-forward oracle;
5. the kernel inside the model: full width in fp32, kernel path on the card
   against the plain path on the host;
6. one JSON line of kernel results, then the result line.

Every phase fails loudly; the last line is printed only when all passed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from fiber_torch.config import FiberConfig
from fiber_torch.kernels import _build
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.models.swin import relative_position_index, shifted_window_mask
from fiber_torch.objectives import retrieval
from fiber_torch.ops.window_attention import (window_attention,
                                              window_attention_reference)

SEED = 0
# published H100 SXM peaks (dense): HBM bytes/s; bf16 tensor-core and fp32
# CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# the kernel row of the result line: the fused-tail stage-3 shape of the
# rerank (pair batch 16), the shape the main path launches most
REPORT_SHAPE = (torch.bfloat16, 16, 2)


def info(**kw) -> None:
    print(json.dumps(kw), flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def swin_bias(gen: torch.Generator, window: int, h: int, H: int, W: int,
              shifted: bool) -> torch.Tensor:
    """(nW, h, N, N) fp32 bias as a Swin block builds it: a seeded RPB table
    gathered by the relative position index, plus the -100 shift mask, or
    without a mask broadcast over the windows (stride 0)."""
    N = window * window
    nW = (H // window) * (W // window)
    table = torch.randn((2 * window - 1) ** 2, h, generator=gen) * 0.02
    idx = torch.from_numpy(relative_position_index(window).astype(np.int64))
    rpb = table[idx.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)[None]
    if shifted:
        mask = torch.from_numpy(shifted_window_mask(H, W, window, window // 2))
        return (rpb + mask[:, None]).contiguous().cuda()
    return rpb.contiguous().cuda().expand(nW, h, N, N)


def kernel_timing(qkv: torch.Tensor, bias: torch.Tensor, h: int) -> dict:
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // h
    esz = qkv.element_size()
    bias_bytes = (bias.numel() if bias.stride(0) else bias[0].numel()) * 4
    nbytes = qkv.numel() * esz + B * nW * N * C * esz + bias_bytes
    flops = B * nW * h * 4 * N * N * hd          # q.k^T and p.v
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[qkv.dtype] * 1e3
    # the library yardstick: SDPA on the same q, k, v with the bias as a
    # float mask, its inputs laid out for it outside the timed call
    x = qkv.view(B * nW, N, 3, h, hd)
    q, k, v = (x[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    mask = bias.expand(B, nW, h, N, N).reshape(B * nW, h, N, N).to(qkv.dtype)
    return dict(
        ms=cuda_time_ms(lambda: window_attention(qkv, bias, h)),
        plain_ms=cuda_time_ms(lambda: window_attention_reference(qkv, bias, h)),
        library_ms=cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_kernel(gen, B, H, W, window, h, hd, dtype, shifted, timed) -> dict:
    """K1 against its plain version at one shape; optionally timed."""
    bias = swin_bias(gen, window, h, H, W, shifted)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to("cuda", dtype)
    out = window_attention(qkv, bias, h)
    ref = window_attention_reference(qkv, bias, h)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), **TOL[dtype])
    row = dict(phase="k1_check", B=B, nW=nW, N=N, h=h, hd=hd,
               dtype=str(dtype).replace("torch.", ""), shift_mask=shifted,
               max_abs_err=err, ok=ok)
    if not ok:
        info(**row)
        raise AssertionError(f"K1 disagrees with its plain version: {row}")
    if timed:
        row.update(kernel_timing(qkv, bias, h))
    info(**row)
    return row


def profile_share(fn) -> dict:
    """Device time of one call of `fn` by kernel (torch.profiler): the
    wall time, the summed kernel time, K1's part and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    total = sum(kernels.values())
    k1 = sum(v for k, v in kernels.items() if "window_attention" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms, kernel_ms=total, k1_ms=k1,
                busy_share=total / wall_ms,
                top_kernels=[[k[:60], v] for k, v in top])


def seeded_gates(model: FiberCoarse, seed: int) -> None:
    """Fusion gates uniform in [0.3, 0.7] (they start at 0, which would make
    the cross-attention paths no-ops)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("alpha_i2t", "alpha_t2i")):
                p.copy_(torch.empty(p.shape).uniform_(0.3, 0.7, generator=gen))


def corpus(cfg: FiberConfig, n_img: int, n_txt: int, seed: int):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n_img, cfg.image_size, cfg.image_size, 3)
                                 ).astype(np.float32)
    ids = rng.integers(3, cfg.vocab_size, (n_txt, cfg.max_text_len))
    masks = np.ones_like(ids)
    masks[1::3, cfg.max_text_len // 2:] = 0        # some padded texts
    ids[masks == 0] = cfg.pad_token_id
    return images, ids, masks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    info(phase="device", nvidia_smi=card, kind=kind, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    took = _build.build(["window_attention"])
    ptxas = [ln.strip() for ln in
             _build.build_logs.get("window_attention", "").splitlines()
             if "registers" in ln or "spill" in ln]
    info(phase="build", seconds=time.perf_counter() - t0, per_source=took,
         ptxas=ptxas[:20])

    # ---- 3. K1 against its plain version ----------------------------------
    gen = torch.Generator().manual_seed(SEED)
    base = FiberConfig.base()
    win = base.derived_window_size
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for B in (2, 16):
                for s in range(4):
                    g = base.stage_resolution(s)[0]
                    rows[(dtype, B, s)] = check_kernel(
                        gen, B, g, g, win, base.swin_num_heads[s], 32, dtype,
                        shifted=g > win, timed=True)
            g = base.stage_resolution(0)[0]
            check_kernel(gen, 2, g, g, win, 4, 32, dtype, shifted=False,
                         timed=False)                 # broadcast bias
            check_kernel(gen, 2, 7, 21, 7, 4, 32, dtype, shifted=True,
                         timed=False)                 # N = 49, nW = 3

    # ---- 4. the main path: FIBER-Base 384^2 bf16 ITM rerank ---------------
    cfg = FiberConfig.base()
    n_img, n_txt, pair_batch = 4, 8, 16
    t0 = time.perf_counter()
    model = FiberCoarse(cfg, device="cuda", seed=SEED).eval()
    seeded_gates(model, SEED)
    info(phase="model", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()))
    images, ids, masks = corpus(cfg, n_img, n_txt, SEED)
    img_emb, txt_emb = retrieval.encode_corpus(model, images, ids, masks,
                                               batch_size=n_img)
    itc = retrieval.itc_score_matrix(img_emb, txt_emb)

    def rerank():
        return retrieval.itm_rerank_matrix(model, images, ids, masks, itc,
                                           rerank_topk=n_txt,
                                           pair_batch=pair_batch)

    rerank()                                          # warm-up
    torch.cuda.synchronize()
    window_attention.launches = 0
    t0 = time.perf_counter()
    scores = rerank()                                 # ends on a host copy
    seconds = time.perf_counter() - t0
    launches = window_attention.launches
    n_pairs = n_img * n_txt
    trunk_blocks = sum(cfg.swin_depths[:3]) - (cfg.num_fuse_block
                                               - cfg.swin_depths[3])
    n_trunk_batches = 1                               # trunk batch = n_img
    expect = (n_trunk_batches * trunk_blocks
              + n_pairs // pair_batch * cfg.num_fuse_block)
    info(phase="rerank", pairs=n_pairs, seconds=seconds,
         pairs_per_s=n_pairs / seconds, card=card, launches=launches,
         expected_launches=expect)
    if launches != expect:
        raise AssertionError(f"window attention launched {launches} times "
                             f"on the main path, expected {expect}")
    top = np.argsort(-itc, axis=1)[:, :n_txt]
    pair_img, pair_txt = np.repeat(np.arange(n_img), n_txt), top.reshape(-1)
    cached = scores[pair_img, pair_txt]
    if cached.shape != (n_pairs,) or not np.isfinite(cached).all():
        raise AssertionError(f"rerank scores not finite: {cached}")

    window_attention.launches = 0
    oracle = retrieval._rank_pairs_full(model, images, ids, masks, pair_img,
                                        pair_txt, pair_batch).cpu().numpy()
    oracle_launches = window_attention.launches
    if oracle_launches != n_pairs // pair_batch * sum(cfg.swin_depths):
        raise AssertionError(f"oracle launched the kernel {oracle_launches} "
                             f"times")
    # bf16: the trunk runs at batch 4 here and at 16 in the oracle, where the
    # matrix products may take other kernels and round differently
    diff = float(np.abs(cached - oracle).max())
    info(phase="rerank_vs_oracle", max_abs_diff=diff,
         max_abs_score=float(np.abs(oracle).max()), atol=5e-2, rtol=5e-2,
         oracle_launches=oracle_launches)
    np.testing.assert_allclose(cached, oracle, atol=5e-2, rtol=5e-2)
    info(phase="rerank_profile", card=card, **profile_share(rerank))
    del model
    torch.cuda.empty_cache()

    # ---- 5. kernel path on the card against the plain path on the host ----
    cfg32 = FiberConfig.base(compute_dtype=torch.float32)
    gpu = FiberCoarse(cfg32, device="cuda", seed=SEED).eval()
    cpu = FiberCoarse(cfg32, device="cpu", seed=SEED).eval()
    seeded_gates(gpu, SEED)
    seeded_gates(cpu, SEED)
    x = (torch.from_numpy(images[:2]), torch.from_numpy(ids[:2]),
         torch.from_numpy(masks[:2]))
    with torch.inference_mode():
        window_attention.launches = 0
        og = gpu.infer(*(t.cuda() for t in x))
        rg = gpu.rank_scores(og["cls_feats"])
        gpu_launches = window_attention.launches
        oc = cpu.infer(*x)
        rc = cpu.rank_scores(oc["cls_feats"])
    d_cls = (og["cls_feats"].cpu() - oc["cls_feats"]).abs().max().item()
    d_rank = (rg.cpu() - rc).abs().max().item()
    info(phase="fp32_card_vs_host", cls_feats_max_abs_diff=d_cls,
         rank_max_abs_diff=d_rank, atol=1e-3, launches=gpu_launches)
    if gpu_launches != sum(cfg32.swin_depths):
        raise AssertionError(f"fp32 forward launched {gpu_launches} times")
    if not (d_cls <= 1e-3 and d_rank <= 1e-3):
        raise AssertionError("kernel path and plain path disagree at full "
                             "width in fp32")

    # ---- 6. result ---------------------------------------------------------
    r = rows[REPORT_SHAPE]
    info(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "window_attention", "route": "cuda",
        "source": "fiber_torch/csrc/window_attention.cu",
        "replaces": "fiber_tpu/ops/window_attention.py:253",
        "launches": launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": {k: r[k] for k in ("B", "nW", "N", "h", "hd", "dtype")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
