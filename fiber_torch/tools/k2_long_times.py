"""Device time of the bf16 window-attention backward at FIBER's 576^2
windows (K2 on its long-window route, 18 x 18 windows, N = 324), its row
and column kernels apart.

    python -m fiber_torch.tools.k2_long_times [--batch 8] [--reps 20]
                                               [--seed 0]

At each of the four stages of the 576^2 presets (64, 16, 4 and 1 windows;
4, 8, 16 and 32 heads of 32; shifted where a stage has more than one
window) it runs `window_attention_bwd` on seeded bf16 inputs: first the
whole call timed on CUDA events (`--reps` calls queued behind a spin, as
`chip_smoke.py` times kernels), then `--reps` calls under torch.profiler,
whose device events give each kernel's time by name (the row kernel's,
the column kernel's and, where the batch is split, the sum of the dbias
partials).  It uses only the op's public entry, so it times whichever
design the checkout it runs from holds: run it from two checkouts in one
call on one card to compare them.  Prints one JSON line a stage, with the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict

import numpy as np
import torch

from fiber_torch.config import task_finetune_vqa
from fiber_torch.models.swin import (relative_position_index,
                                     shifted_window_mask)
from fiber_torch.ops.window_attention import window_attention_bwd


def stage_inputs(stage: int, B: int, seed: int):
    """(qkv, bias, dout, heads) of one 576^2 stage: a seeded position-bias
    table gathered as a Swin block gathers it, plus the shift mask where
    the stage has more than one window."""
    cfg = task_finetune_vqa()
    win = cfg.derived_window_size
    g = cfg.stage_resolution(stage)[0]
    h, hd = cfg.swin_num_heads[stage], 32
    N, nW = win * win, (g // win) ** 2
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((2 * win - 1) ** 2, h, generator=gen) * 0.02
    idx = torch.from_numpy(relative_position_index(win).astype(np.int64))
    bias = table[idx.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)[None]
    if g > win:
        mask = torch.from_numpy(shifted_window_mask(g, g, win, win // 2))
        bias = bias + mask[:, None]
    bias = bias.expand(nW, h, N, N).contiguous().cuda()
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=gen).to(
        "cuda", torch.bfloat16)
    dout = torch.randn(B, nW, N, h * hd, generator=gen).to(
        "cuda", torch.bfloat16)
    return qkv, bias, dout, h


def event_ms(fn, reps: int) -> float:
    """Device ms of one call: CUDA events around `reps` calls queued
    behind a spin kernel, after three warm-up calls."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int) -> Dict[str, float]:
    """Device ms of one call by kernel name, from torch.profiler's device
    events over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return {k: v / reps for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_long_times: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    for stage in range(4):
        qkv, bias, dout, h = stage_inputs(stage, args.batch,
                                          args.seed + stage)
        call = lambda: window_attention_bwd(qkv, bias, dout, h)
        ms = event_ms(call, args.reps)
        by_name = kernel_ms(call, args.reps)
        part = lambda key: sum(v for k, v in by_name.items() if key in k)
        print(json.dumps(dict(
            stage=stage + 1, batch=args.batch, nW=bias.shape[0], heads=h,
            N=bias.shape[2], card=card, ms=ms,
            rows_ms=part("window_attention_bwd_rows"),
            cols_ms=part("window_attention_bwd_cols"),
            sum_splits_ms=part("sum_splits"),
            plan=list(getattr(window_attention_bwd, "last_plan", ())),
            kernels={k[:80]: v for k, v in by_name.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
