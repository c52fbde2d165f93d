"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the port's CUDA kernels from `fiber_torch/csrc/`, one
   nvcc per source, all started together;
3. K1 (window attention forward) against its plain PyTorch version on the
   card at every FIBER-Base 384^2 stage shape, fp32 (TF32 off) and bf16,
   with kernel, plain and library (SDPA) times and the card's bound;
4. K2 (its backward) likewise, at batch 2 and at the train step's largest
   batch (the 3B images of the hard-negative ITM forward), the library
   yardstick being SDPA's backward with the bias as a mask that needs grad;
5. the serving path: FIBER-Base 384^2 bf16 ITM rerank (`itm_rerank_matrix`
   -> `rank_pairs_pipeline`) on seeded weights with non-zero fusion gates,
   4 images x 8 texts; the launch count shows K1 ran in every Swin block,
   and the cached scores are held against the full-forward oracle;
6. the forward kernel inside the model: full width in fp32, kernel path on
   the card against the plain path on the host;
7. the training path: `CoarseTrainer` on FIBER-Base 384^2 (full width and
   depth, bf16 compute, fp32 parameters, the 4096-slot queue, remat as the
   config sets it), MLM + ITC + hard-negative ITM, B = 8, `STEPS` steps on
   one batch; losses, step time, peak memory and the K1 / K2 launches of
   every step, held to the counts the model implies; then one step under
   the profiler;
8. the backward kernel inside the model: full width in fp32, gradients of
   MLM + ITM on fixed negatives on the card (K1 + K2) against the host's
   plain path;
9. one JSON line of kernel results, then the result line.

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
from fiber_torch.objectives import coarse, retrieval
from fiber_torch.ops.window_attention import (window_attention,
                                              window_attention_bwd,
                                              window_attention_bwd_reference,
                                              window_attention_reference)
from fiber_torch.train.trainer import CoarseTrainer

SEED = 0
# published H100 SXM peaks (dense): HBM bytes/s; bf16 tensor-core and fp32
# CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# the kernel rows of the result line: K1 at the fused-tail stage-3 shape of
# the rerank (pair batch 16), the shape the rerank launches most; K2 at
# stage 3 (18 of the 24 blocks) and the train step's largest batch
REPORT_SHAPE = (torch.bfloat16, 16, 2)
TRAIN_B = 8                     # images per train step; ITM forwards 3 B
STEPS = 5
REPORT_SHAPE_BWD = (torch.bfloat16, 3 * TRAIN_B, 2)
# fp32 gradients, card against host: max |diff| <= GRAD_RTOL * max |host|
GRAD_RTOL = 1e-3


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


def bound(nbytes: int, flops: int, dtype: torch.dtype) -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its peak for the type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bias_bytes(bias: torch.Tensor) -> int:
    """fp32 bias bytes, counted once even when broadcast over windows."""
    return (bias.numel() if bias.stride(0) else bias[0].numel()) * 4


def kernel_timing(qkv: torch.Tensor, bias: torch.Tensor, h: int) -> dict:
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // h
    esz = qkv.element_size()
    nbytes = qkv.numel() * esz + B * nW * N * C * esz + bias_bytes(bias)
    flops = B * nW * h * 4 * N * N * hd          # q.k^T and p.v
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
        **bound(nbytes, flops, qkv.dtype))


def bwd_timing(qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor,
               h: int) -> dict:
    B, nW, N, C3 = qkv.shape
    hd = C3 // 3 // h
    esz = qkv.element_size()
    # qkv and dout read, dqkv written, the bias read and dbias written
    nbytes = ((2 * qkv.numel() + dout.numel()) * esz + bias_bytes(bias)
              + nW * h * N * N * 4)
    flops = B * nW * h * 10 * N * N * hd         # five products
    # the library yardstick: the backward alone of SDPA, windows and heads
    # folded into one axis, the bias a (1, nW h, N, N) mask that needs grad
    # (its gradient summed over the batch, as dbias is)
    x = qkv.view(B, nW, N, 3, h, hd)
    q, k, v = (x[:, :, :, i].permute(0, 1, 3, 2, 4).reshape(B, nW * h, N, hd)
               .detach().requires_grad_(True) for i in range(3))
    mask = (bias.to(qkv.dtype).reshape(1, nW * h, N, N).detach().clone()
            .requires_grad_(True))
    g = dout.view(B, nW, N, h, hd).permute(0, 1, 3, 2, 4).reshape(
        B, nW * h, N, hd)
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (q, k, v, mask), g, retain_graph=True))
    return dict(
        ms=cuda_time_ms(lambda: window_attention_bwd(qkv, bias, dout, h)),
        plain_ms=cuda_time_ms(
            lambda: window_attention_bwd_reference(qkv, bias, dout, h)),
        library_ms=library_ms, library=out.grad_fn.name(),
        **bound(nbytes, flops, qkv.dtype))


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


def check_bwd_kernel(gen, B, H, W, window, h, hd, dtype, shifted,
                     timed) -> dict:
    """K2 against its plain version at one shape; optionally timed."""
    bias = swin_bias(gen, window, h, H, W, shifted)
    nW, N = bias.shape[0], bias.shape[2]
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to("cuda", dtype)
    dout = torch.randn(B, nW, N, h * hd, generator=gen).to("cuda", dtype)
    dqkv, dbias = window_attention_bwd(qkv, bias, dout, h)
    rq, rb = window_attention_bwd_reference(qkv, bias, dout, h)
    torch.cuda.synchronize()
    err_q = (dqkv.float() - rq.float()).abs().max().item()
    err_b = (dbias - rb).abs().max().item()
    ok = (torch.allclose(dqkv.float(), rq.float(), **TOL[dtype])
          and torch.allclose(dbias, rb, **TOL[dtype]))
    row = dict(phase="k2_check", B=B, nW=nW, N=N, h=h, hd=hd,
               dtype=str(dtype).replace("torch.", ""), shift_mask=shifted,
               broadcast_bias=bias.stride(0) == 0, max_abs_err_dqkv=err_q,
               max_abs_err_dbias=err_b, max_abs_err=max(err_q, err_b), ok=ok)
    if not ok:
        info(**row)
        raise AssertionError(f"K2 disagrees with its plain version: {row}")
    if timed:
        row.update(bwd_timing(qkv, bias, dout, h))
    info(**row)
    return row


def profile_share(fn) -> dict:
    """Device time of one call of `fn` by kernel (torch.profiler): the
    wall time, the summed kernel time, K1's and K2's parts and the largest
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the ranges of user annotations (such as
    # the optimizer's step), whose kernels are counted on their own
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)}
    total = sum(kernels.values())
    k1 = sum(v for k, v in kernels.items() if "window_attention_fwd" in k)
    k2 = sum(v for k, v in kernels.items() if "window_attention_bwd" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_ms=wall_ms, kernel_ms=total, k1_ms=k1, k2_ms=k2,
                k1_share=k1 / total, k2_share=k2 / total,
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


def train_batch(cfg: FiberConfig, B: int, seed: int) -> dict:
    """A numpy pretraining batch: the corpus's images and texts, 15% of
    the real tokens masked for MLM (<mask> in, the id as the label)."""
    images, ids, masks = corpus(cfg, B, B, seed)
    rng = np.random.default_rng(seed + 1)
    pick = (rng.random(ids.shape) < 0.15) & (masks == 1)
    pick[:, 1] = True
    return {"image": images, "text_ids": ids, "text_masks": masks,
            "text_ids_mlm": np.where(pick, cfg.vocab_size - 1, ids),
            "text_labels_mlm": np.where(pick, ids, -100)}


GRAD_CHECKED = ("relative_position_bias_table", "alpha_i2t", "alpha_t2i")


def expected_launches(cfg: FiberConfig, forwards: int) -> tuple:
    """(K1, K2) launches of one step whose losses run `forwards` Swin
    forwards, the MLM fused forward among them.  K1 runs in every block
    of each.  The backward (K2, and K1 again in the recompute under remat)
    runs in every block whose output reaches a loss: all but the MLM
    forward's last block, whose output feeds only the image features that
    MLM does not read (the last text layer reads that block's input)."""
    blocks = sum(cfg.swin_depths)
    k2 = forwards * blocks - 1
    return forwards * blocks + (k2 if cfg.remat else 0), k2


def run_training(card: str) -> dict:
    """Phase 7: STEPS full-width bf16 train steps on one batch, each with
    the launch counts set to 0 before it and read after it; then one step
    under the profiler."""
    cfg = FiberConfig.base(loss_names=("itm", "mlm", "itc"), warmup_steps=0,
                           learning_rate=1e-4)
    t0 = time.perf_counter()
    trainer = CoarseTrainer(cfg, device="cuda", seed=SEED)
    seeded_gates(trainer.model, SEED)
    info(phase="train_model", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in trainer.params),
         queue_slots=trainer.queue.size, remat=cfg.remat, batch=TRAIN_B,
         dropout=cfg.drop_rate, drop_path=cfg.swin_drop_path_rate)
    batch = trainer.to_device(train_batch(cfg, TRAIN_B, SEED))
    expect_k1, expect_k2 = expected_launches(
        cfg, forwards=2 + (3 if cfg.itm_hardneg_chunk else 1))
    steps = []
    for step in range(STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        window_attention.launches = window_attention_bwd.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k1, k2 = window_attention.launches, window_attention_bwd.launches
        row = dict(phase="train_step", step=step, seconds=seconds, card=card,
                   max_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   k1_launches=k1, k2_launches=k2, expected_k1=expect_k1,
                   expected_k2=expect_k2,
                   **{k: float(v) for k, v in metrics.items()})
        info(**row)
        steps.append(row)
        if (k1, k2) != (expect_k1, expect_k2):
            raise AssertionError(f"train step launched K1 {k1} and K2 {k2} "
                                 f"times, expected {expect_k1} and "
                                 f"{expect_k2}")
        if step == 0:
            checked = [(n, p.grad) for n, p in trainer.model.named_parameters()
                       if n.endswith(GRAD_CHECKED)]
            bad = [n for n, g in checked
                   if not (torch.isfinite(g).all() and g.abs().max() > 0)]
            info(phase="train_grads", checked=len(checked), bad=bad)
            if bad or not checked:
                raise AssertionError(f"zero or non-finite gradients: {bad}")
    mlm = [r["mlm_loss"] for r in steps]
    total = int(trainer.queue.total)
    info(phase="train", steps=STEPS, mlm_first=mlm[0], mlm_last=mlm[-1],
         queue_total=total, expected_queue_total=STEPS * TRAIN_B)
    if not all(np.isfinite(r[k]) for r in steps for k in r
               if k.endswith("_loss")):
        raise AssertionError(f"non-finite losses: {steps}")
    if not mlm[-1] < mlm[0]:
        raise AssertionError(f"the MLM loss did not fall: {mlm}")
    if total != STEPS * TRAIN_B:
        raise AssertionError(f"the queue took {total} rows")
    prof = profile_share(lambda: trainer.train_step(batch))
    info(phase="train_profile", card=card, **prof)
    del trainer, batch
    torch.cuda.empty_cache()
    return dict(k1=steps[-1]["k1_launches"], k2=steps[-1]["k2_launches"])


def grads_card_vs_host(card: str) -> None:
    """Phase 8: fp32, dropout and drop-path 0, B = 2; gradients of MLM +
    ITM on fixed negatives (each row's neighbour in the batch), card
    (K1 + K2) against the host's plain path."""
    cfg = FiberConfig.base(compute_dtype=torch.float32, drop_rate=0.0,
                           swin_drop_path_rate=0.0,
                           loss_names=("itm", "mlm", "itc"))
    data = train_batch(cfg, 2, SEED + 1)
    picked = {f"vit_model.layers.{s}.blocks.{b}.attn.qkv.weight"
              for s, depth in enumerate(cfg.swin_depths) for b in (0, depth - 1)}
    grads, losses, counts = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = FiberCoarse(cfg, device=dev, seed=SEED, for_training=True)
        seeded_gates(model, SEED)
        b = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
        neg = {"image_neg": b["image"].roll(1, 0),
               "text_neg": b["text_ids"].roll(1, 0),
               "text_mask_neg": b["text_masks"].roll(1, 0)}
        window_attention.launches = window_attention_bwd.launches = 0
        loss = (coarse.compute_mlm(model, b)["mlm_loss"]
                + coarse.compute_itm_hardneg(model, b, neg)["itm_loss"])
        loss.backward()
        counts[dev] = (window_attention.launches, window_attention_bwd.launches)
        losses[dev] = float(loss.detach())
        grads[dev] = {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters()
                      if n.endswith(GRAD_CHECKED) or n in picked}
        info(phase="fp32_grad_pass", device=dev,
             seconds=time.perf_counter() - t0, loss=losses[dev],
             k1_launches=counts[dev][0], k2_launches=counts[dev][1])
        del model, loss
        torch.cuda.empty_cache()
    rel = {n: ((grads["cuda"][n] - g).abs().max() / g.abs().max()).item()
           for n, g in grads["cpu"].items()}
    worst = max(rel, key=lambda n: rel[n] if np.isfinite(rel[n]) else np.inf)
    expect = expected_launches(cfg, forwards=2)      # MLM and ITM forwards
    info(phase="fp32_grad_card_vs_host", card=card, tensors=len(rel),
         worst_rel_err=rel[worst], worst_tensor=worst, limit=GRAD_RTOL,
         loss_card=losses["cuda"], loss_host=losses["cpu"],
         launches=counts["cuda"], expected_launches=expect)
    if counts["cuda"] != expect or counts["cpu"] != (0, 0):
        raise AssertionError(f"launches {counts}: expected (K1, K2) {expect} "
                             f"on the card and nothing on the host")
    if not rel[worst] <= GRAD_RTOL:
        raise AssertionError(f"card and host gradients differ: {worst} "
                             f"relative error {rel[worst]}")
    if not abs(losses["cuda"] - losses["cpu"]) <= GRAD_RTOL * abs(losses["cpu"]):
        raise AssertionError(f"card and host losses differ: {losses}")


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
    sources = ["window_attention", "window_attention_bwd"]
    took = _build.build(sources)
    ptxas = {n: [ln.strip() for ln in _build.build_logs.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln][:20] for n in sources}
    info(phase="build", seconds=time.perf_counter() - t0, per_source=took,
         ptxas=ptxas)

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

    # ---- 4. K2 against its plain version ----------------------------------
    bwd_rows = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for B in (2, 3 * TRAIN_B):
                for s in range(4):
                    g = base.stage_resolution(s)[0]
                    bwd_rows[(dtype, B, s)] = check_bwd_kernel(
                        gen, B, g, g, win, base.swin_num_heads[s], 32, dtype,
                        shifted=g > win, timed=True)
            g = base.stage_resolution(0)[0]
            check_bwd_kernel(gen, 2, g, g, win, 4, 32, dtype, shifted=False,
                             timed=False)             # broadcast bias
    torch.cuda.empty_cache()

    # ---- 5. the serving path: FIBER-Base 384^2 bf16 ITM rerank ------------
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

    # ---- 6. kernel path on the card against the plain path on the host ----
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
    del gpu, cpu, og, oc
    torch.cuda.empty_cache()

    # ---- 7. the training path: FIBER-Base 384^2 bf16 train steps ----------
    train = run_training(card)

    # ---- 8. K2 inside the model: fp32 gradients, card against host --------
    grads_card_vs_host(card)

    # ---- 9. result ---------------------------------------------------------
    shape_keys = ("B", "nW", "N", "h", "hd", "dtype")
    r, rb = rows[REPORT_SHAPE], bwd_rows[REPORT_SHAPE_BWD]
    info(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "window_attention", "route": "cuda",
        "source": "fiber_torch/csrc/window_attention.cu",
        "replaces": "fiber_tpu/ops/window_attention.py:253",
        "launches": launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "launches_by_path": {"rerank": launches, "train_step": train["k1"]},
        "shape": {k: r[k] for k in shape_keys}}, {
        "name": "window_attention_bwd", "route": "cuda",
        "source": "fiber_torch/csrc/window_attention_bwd.cu",
        "replaces": "fiber_tpu/ops/window_attention.py:352",
        "launches": train["k2"], "max_abs_err": rb["max_abs_err"],
        "ms": rb["ms"], "plain_ms": rb["plain_ms"],
        "bound_ms": rb["bound_ms"], "bound_by": rb["bound_by"],
        "library_ms": rb["library_ms"], "library": rb["library"],
        "launches_by_path": {"train_step": train["k2"]},
        "shape": {k: rb[k] for k in shape_keys}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
