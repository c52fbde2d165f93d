"""Measure input-pipeline throughput: PIL-geometry path vs decode-only
staging for the on-device pipeline, and the device pipeline itself.

    python -m fiber_torch.tools.bench_input [--n 64] [--size 640x480]
        [--image-size 384] [--reps 3] [--device cuda|cpu]

The PyTorch counterpart of the JAX repo's `tools/bench_input.py`.  It
writes `--n` seeded JPEGs and prints ex/s for:
  pil      decode + RandomResizedCrop + HFlip + bicubic resize + fp32
           normalize on the host (the reference's dataloader work,
           transform.py:29-45; `data/transforms.py::resize_image`)
  staged   decode + uint8 staging only (the host side of the device
           pipeline, `data/device_transforms.py::stage_host`)
  device   `data/device_transforms.py::device_train_preprocess` on
           `--device` (bf16 out), timed to a host sync
It needs PIL to write and decode the JPEGs: without PIL it stops at once
with an error and prints no row.
"""

from __future__ import annotations

import argparse
import io
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _median_s(fn, reps: int) -> float:
    fn()                                              # warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--image-size", type=int, default=384)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    W, H = (int(x) for x in args.size.split("x"))

    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit(f"bench_input needs PIL to write and decode its "
                         f"JPEGs: {e}")

    from fiber_torch.data.device_transforms import (device_train_preprocess,
                                                    stage_host)
    from fiber_torch.data.transforms import resize_image

    rng = np.random.default_rng(0)
    blobs = []
    for _ in range(args.n):
        # low-frequency content so JPEG decode cost is realistic
        small = rng.integers(0, 256, (H // 16, W // 16, 3), np.uint8)
        img = Image.fromarray(small).resize((W, H), Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=90)
        blobs.append(buf.getvalue())

    S = args.image_size
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    def pil_path():
        out = []
        r = np.random.default_rng(1)
        for b in blobs:
            arr = resize_image(Image.open(io.BytesIO(b)), S, train=True,
                               rng=r)
            out.append((arr.astype(np.float32) / 255.0 - mean) / std)
        return np.stack(out)

    staging = (S * 3) // 2

    def staged_path():
        st, sz = [], []
        for b in blobs:
            a, s = stage_host(Image.open(io.BytesIO(b)), staging)
            st.append(a)
            sz.append(s)
        return np.stack(st), np.stack(sz)

    rates = {}
    for label, fn in (("pil", pil_path), ("staged", staged_path)):
        dt = _median_s(fn, args.reps)
        rates[label] = args.n / dt
        print(f"{label:7s} {args.n / dt:8.1f} ex/s "
              f"({dt / args.n * 1e3:6.2f} ms/img host)", flush=True)

    device = torch.device(args.device)
    staged, sizes = staged_path()
    dst = torch.from_numpy(staged).to(device)
    dsz = torch.from_numpy(sizes).to(device)
    seed = [0]

    def dev():
        seed[0] += 1
        gen = torch.Generator(device=device).manual_seed(seed[0])
        img = device_train_preprocess(dst, dsz, gen, S,
                                      dtype=torch.bfloat16)
        return float(img.float().sum())                # a host sync

    dt = _median_s(dev, args.reps)
    rates["device"] = args.n / dt
    print(f"device  {args.n / dt:8.1f} ex/s ({dt / args.n * 1e3:6.2f} "
          f"ms/img on {device})", flush=True)
    return rates


if __name__ == "__main__":
    main()
