"""Per-component time of the fused rerank tail, FIBER-Base 384^2.

    python -m fiber_torch.tools.profile_tail --batch 64 [--iters 20]
                                             [--device cuda] [--seed 0]

The port of the JAX package's `tools/profile_tail.py`.  At the rerank
tail's shapes (B pairs; stage 3 24x24x512 in 4 windows of 144 tokens with
16 heads, stage 4 12x12x1024, 40 text tokens of width 768) and on weights
drawn from `--seed`, it times:

  blk3      one fused stage-3 Swin block with text (the first fused block)
  blk4      one fused stage-4 block with text
  txt       one fused RoBERTa layer with image K/V from stage-3 tokens
  wa        window attention through the op (K1 on the card)
  wa_ker    the per-head kernel (K4) on pre-transposed operands
  wa_tr     the head-split transpose alone, (B, nW, N, 3C) -> 3 x (B, nW,
            h, N, hd)
  wa_plain  the plain PyTorch window attention

and prints one JSON line per component: the milliseconds of one call and
per item, and the FLOP rate where the JAX tool gives one, from FLOP counted
from the shapes.  On the card (the default) times are device times from
CUDA events over `--iters` calls after warm-up; with `--device cpu` they
are host times of the plain paths, marked `"clock": "host"`.  The JAX
tool's `scan_reps` / `null` baseline works around a TPU runtime's fixed
cost per call and has no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse, resolve_device
from fiber_torch.ops.window_attention import (split_heads_qkv,
                                              window_attention,
                                              window_attention_heads,
                                              window_attention_reference)

COMPONENTS = ("blk3", "blk4", "txt", "wa", "wa_ker", "wa_tr", "wa_plain")


def swin_block_flops(tokens: int, C: int, N: int, hidden: int,
                     text_len: int = 0, text_dim: int = 0) -> int:
    """FLOP of one Swin block over `tokens` tokens in windows of N, with
    i2t attention over `text_len` tokens of width `text_dim` if given."""
    f = 2 * tokens * (3 * C * C + C * C + 2 * C * hidden)  # qkv proj fc1 fc2
    f += 4 * tokens * N * C                                # q.k^T, p.v
    if text_len:
        f += 2 * text_len * text_dim * 2 * C               # text keys, values
        f += 2 * tokens * C * C * 2                        # queries, proj_i2t
        f += 4 * tokens * text_len * C                     # logits, p.v
    return f


def text_layer_flops(L: int, H: int, inter: int, image_tokens: int = 0,
                     image_dim: int = 0) -> int:
    """FLOP of one RoBERTa layer over L tokens of width H, with t2i
    attention over `image_tokens` of width `image_dim` if given."""
    f = 2 * L * H * 3 * H + 4 * L * L * H + 2 * L * H * H  # self-attention
    f += 2 * 2 * L * H * inter                             # intermediate, output
    if image_tokens:
        f += 2 * L * H * H + 2 * 2 * image_tokens * image_dim * H
        f += 4 * L * image_tokens * H + 2 * L * H * H      # logits, p.v, out
    return f


def window_attention_flops(nW: int, h: int, N: int, hd: int) -> int:
    """FLOP of window attention per item: q.k^T and p.v per (window, head)."""
    return 4 * nW * h * N * N * hd


def build_components(cfg: FiberConfig, batch: int, device, seed: int = 0
                     ) -> Dict[str, Tuple[Callable[[], torch.Tensor],
                                          Optional[int]]]:
    """name -> (a call of the component on its inputs, its FLOP or None),
    at `cfg`'s rerank-tail shapes with `batch` items, on `device`."""
    dev = resolve_device(device)
    c = cfg
    dt = c.compute_dtype
    model = FiberCoarse(c, device=dev, seed=seed).eval()
    rng = np.random.default_rng(seed)

    def normal(shape, scale, dtype=dt):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, dtype)

    B = batch
    swin, text_layers = model.vit_model, model.text_transformer.layers
    n_tail = c.num_fuse_block - c.swin_depths[3]
    blk3 = swin.layers[2].blocks[c.swin_depths[2] - n_tail]
    blk4 = swin.layers[3].blocks[0]
    layer = text_layers[c.num_text_layers - c.num_fuse_block]
    H3, C3 = c.stage_resolution(2)[0], c.stage_dim(2)
    H4, C4 = c.stage_resolution(3)[0], c.stage_dim(3)
    L, Ht = c.max_text_len, c.text_hidden_size

    x3 = normal((B, H3, H3, C3), 0.1)
    x4 = normal((B, H4, H4, C4), 0.1)
    text = normal((B, L, Ht), 0.1)
    text_bias = torch.zeros((B, L), dtype=dt, device=dev)
    ext_mask = torch.zeros((B, 1, 1, L), dtype=dt, device=dev)
    img_tokens = x3.reshape(B, H3 * H3, C3)

    h = c.swin_num_heads[2]
    N = blk3.window * blk3.window
    nW = (H3 // blk3.window) ** 2
    hd = C3 // h
    qkv = normal((B, nW, N, 3 * C3), 0.1)
    bias = normal((nW, h, N, N), 0.1, torch.float32)
    q, k, v = split_heads_qkv(qkv, h)
    wa_flops = B * window_attention_flops(nW, h, N, hd)

    def blk_flops(blk, tokens, C):
        return B * swin_block_flops(tokens, C, blk.window ** 2,
                                    blk.mlp.fc1.out_features, L, Ht)

    return {
        "blk3": (lambda: blk3(x3, text, text_bias),
                 blk_flops(blk3, H3 * H3, C3)),
        "blk4": (lambda: blk4(x4, text, text_bias),
                 blk_flops(blk4, H4 * H4, C4)),
        "txt": (lambda: layer(text, attn_mask=ext_mask,
                              image_feats=img_tokens),
                B * text_layer_flops(L, Ht, c.text_intermediate_size,
                                     H3 * H3, C3)),
        "wa": (lambda: window_attention(qkv, bias, h), wa_flops),
        "wa_ker": (lambda: window_attention_heads(q, k, v, bias), wa_flops),
        "wa_tr": (lambda: split_heads_qkv(qkv, h)[0], None),
        "wa_plain": (lambda: window_attention_reference(qkv, bias, h),
                     wa_flops),
    }


def time_ms(fn: Callable, device: torch.device, iters: int,
            warmup: int = 3) -> float:
    """Milliseconds per call: CUDA events on the card, the host clock on
    the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(cfg: FiberConfig, batch: int = 64, device="cuda", iters: int = 20,
        seed: int = 0) -> List[dict]:
    """One row per component: ms per call and per item, TFLOP/s."""
    dev = resolve_device(device)
    rows = []
    with torch.inference_mode():
        comps = build_components(cfg, batch, dev, seed)
        for name in COMPONENTS:
            fn, flops = comps[name]
            ms = time_ms(fn, dev, iters)
            rows.append(dict(
                component=name, batch=batch, device=str(dev),
                clock="cuda_events" if dev.type == "cuda" else "host",
                ms=ms, ms_per_item=ms / batch, flop=flops,
                tflops=flops / ms / 1e9 if flops else None))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for row in run(FiberConfig.base(), args.batch, dev, args.iters,
                   args.seed):
        print(json.dumps(dict(row, kind=kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
