"""K3's long-window tensor-core route (`csrc/swin_stage_tc_long.cu`, bf16
with 144 < N <= 352: FIBER's 18 x 18 windows at 576^2, N = 324), on the
CPU: the route rule, the plan of its attention items (rows a block, warps a
slab, batch splits) at the 576^2 stages of the caption preset, that its
block fits the kernel's warps and shared memory, that the items cover
every query row once, and a numpy emulation of the attention phase's order
of work against the plain version's attention in bf16.  The kernel itself
is held against the plain version on a CUDA device in
tests/test_torch_kernels.py and by `chip_smoke.py`."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_torch.config import task_finetune_caption_mle
from fiber_torch.models.swin import shifted_window_mask
from fiber_torch.ops import swin_stage as tss
from fiber_torch.ops import window_attention as twa
from torch_long_attention import bf16, two_pass_emulated

torch.set_num_threads(1)

CSRC = Path(tss.__file__).resolve().parent.parent / "csrc"
GRID = 132                      # one block an SM on an H100 SXM


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("N", [145, 196, 256, 324, 352])
def test_k3_route_bf16_long_windows(N, hd):
    """bf16 beyond N = 144 at the tensor cores' head dims runs "tc_long"
    (K1's long-window routine at K3's rounding); fp32 there stays on the
    CUDA cores, and so does bf16 at hd = 128."""
    assert tss._k3_route(torch.bfloat16, N, hd) == "tc_long"
    assert tss._k3_route(torch.float32, N, hd) == "cuda_core"
    assert tss._k3_route(torch.bfloat16, N, 128) == "cuda_core"
    assert tss._k3_route(torch.bfloat16, 144, hd) == "tc"


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"{name} = (\d+);", src).group(1))


def test_long_kernel_constants_are_the_plans():
    """The wrapper's mirror of the kernel: its block of kLongWarps warps
    under __launch_bounds__(kThreads, 1), and the GEMM pipeline's shared
    memory from the shared header's constants."""
    src = (CSRC / "swin_stage_tc_long.cu").read_text()
    head = (CSRC / "swin_stage_tc.cuh").read_text()
    assert _constant(src, "kLongWarps") == tss._K3_LONG_WARPS
    assert "kThreads = kLongWarps * 32;" in src
    assert "__launch_bounds__(kThreads, 1)" in src
    assert re.search(r"attend_long_rows<HD, true>", src)
    bk, stages = _constant(head, "kBK"), _constant(head, "kStages")
    bm, bn = (int(v) for v in re.search(
        r"kMaxBM = (\d+), kMaxBN = (\d+);", head).groups())
    assert "kLds = kBK + 8;" in head
    assert stages * (bm + bn) * (bk + 8) * 2 + 2 * 8 * bm == \
        tss._K3_GEMM_SMEM == 83968


def test_block_shapes_at_324():
    """The shared memory of the three block shapes the kernel's header
    weighs at N = 324, hd = 32, all within a block's 232,448 bytes."""
    smem = lambda R, p: tss._k3_long_smem_bytes(324, 32, R, p)
    assert (smem(48, 3), smem(64, 2), smem(64, 3)) == \
        (194688, 215040, 223744)
    assert max(smem(48, 3), smem(64, 2), smem(64, 3)) <= twa._MAX_SMEM
    # a small window's attention needs less than the GEMM pipeline
    assert tss._k3_long_smem_bytes(145, 8, 16, 1) == tss._K3_GEMM_SMEM
    assert tss._k3_long_rows(324, 32) == (64, 3)


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_every_long_window_has_a_block(hd):
    for N in range(145, twa._LONG_MAX_N + 1):
        R, parts = tss._k3_long_rows(N, hd)
        assert R % 16 == 0 and 16 <= R <= 16 * twa._LONG_MAX_WARPS
        assert R // 16 * parts <= tss._K3_LONG_WARPS
        assert 1 <= parts <= min(twa._LONG_MAX_PARTS, twa._up16(N) // 16)
        assert tss._k3_long_smem_bytes(N, hd, R, parts) <= twa._MAX_SMEM


CAPTION = task_finetune_caption_mle()
# the 576^2 stages: (H = W, C, heads), window 18, MLP 4C
STAGES_576 = [(CAPTION.stage_resolution(s)[0], CAPTION.stage_dim(s),
               CAPTION.swin_num_heads[s]) for s in range(4)]
WIN = CAPTION.derived_window_size


def test_576_stages():
    assert WIN == 18 and CAPTION.swin_mlp_ratio == 4
    assert STAGES_576 == [(144, 128, 4), (72, 256, 8), (36, 512, 16),
                          (18, 1024, 32)]


def _split_range(B, S, s):
    return s * B // S, (s + 1) * B // S


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("B", [1, 2, 4])
def test_long_plan_at_the_576_stages(B, stage):
    """At every 576^2 stage the plan takes the tensor cores' long route with
    R a multiple of 16 on `parts` warps a slab that fit the kernel's block
    and shared memory, and the kernel's item loop (block b runs items b, b
    + grid, ...; item = (split, window, head, row block), row blocks
    fastest) reaches every query row of every (batch element, window,
    head) exactly once."""
    H, C, h = STAGES_576[stage]
    N, hd = WIN * WIN, C // h
    assert tss._k3_route(torch.bfloat16, N, hd) == "tc_long"
    plan = tss._k3_plan(B, H, H, C, 4 * C, WIN, h, GRID)
    R, parts, S = plan["rows"], plan["parts"], plan["splits"]
    assert (R, parts) == (64, 3)
    assert R % 16 == 0 and R // 16 * parts <= tss._K3_LONG_WARPS
    assert tss._k3_long_smem_bytes(N, hd, R, parts) <= twa._MAX_SMEM
    assert all(plan[p] in tss._K3_TILES for p in tss._K3_PRODUCTS)
    nW = (H // WIN) ** 2
    row_blocks = -(-N // R)
    assert 1 <= S <= B
    assert S == twa._bwd_splits(B, nW * row_blocks, h, GRID, 1)
    units = row_blocks * nW * h
    seen = np.zeros((B, nW, h, N), np.int64)
    for block in range(GRID):
        for it in range(block, units * S, GRID):
            s, u = divmod(it, units)
            wh, rb = divmod(u, row_blocks)
            w, head = divmod(wh, h)
            b0, b1 = _split_range(B, S, s)
            seen[b0:b1, w, head, rb * R:min(N, rb * R + R)] += 1
    assert (seen == 1).all()


def test_long_plan_at_stage3_b2():
    """576^2 stage 3 with two blocks at B = 2 (the kernel table's row):
    the four products on 128 x 128 tiles (qkv 252 tiles in two waves of
    132, proj and fc2 84 in one, fc1 336 in three), and the attention's
    384 items (6 row blocks x 4 windows x 16 heads) in one split: 3 waves
    of 2 batch elements."""
    H, C, h = STAGES_576[2]
    plan = tss._k3_plan(2, H, H, C, 4 * C, WIN, h, GRID)
    assert plan == {"qkv": (128, 128), "proj": (128, 128),
                    "fc1": (128, 128), "fc2": (128, 128), "rows": 64,
                    "parts": 3, "splits": 1}
    M = 2 * H * H
    assert [-(-M // 128) * -(-n // 128) for n in (3 * C, C, 4 * C)] == \
        [252, 84, 336]


# ---- the attention phase's order of work, emulated in numpy -------------


@pytest.mark.parametrize("parts", [1, 3])
def test_long_attention_order_matches_the_plain_version(parts):
    """The attention phase's contract (`two_pass_emulated` with K3's
    rounding: scale after the product, rpb + mask staged once, two passes
    with P normalised before it is rounded, the parts' sums in a fixed
    order) against the plain version's attention
    (`_attention_reference`, the lines `fused_swin_blocks_reference` runs)
    in bf16, at N = 324, hd = 32, two heads, on the four windows of a
    shifted 36 x 36 map (the mask blocks keys in three of them): within
    one bf16 ulp at each output row's largest magnitude (as K1's long-
    window rows are held), and bit for bit in at least 90% of the
    outputs."""
    window, h, hd, H = 18, 2, 32, 36
    N, C = window * window, h * hd
    mask = torch.from_numpy(shifted_window_mask(H, H, window, window // 2))
    nW = mask.shape[0]
    assert nW == 4 and (mask[1:] < 0).any() and not (mask[0] < 0).any()
    rng = np.random.default_rng(17 + parts)
    qkv = bf16(rng.standard_normal((1, nW, N, 3 * C)))
    rpb = (rng.standard_normal((h, N, N)) * 0.5).astype(np.float32)
    ref = tss._attention_reference(torch.from_numpy(qkv).bfloat16(),
                                   torch.from_numpy(rpb), mask, h)
    assert ref.dtype == torch.bfloat16
    ref = ref.float().numpy()
    m = mask.numpy()
    got = np.zeros_like(ref)
    for w in range(nW):
        for head in range(h):
            q, k, v = (qkv[0, w, :, i * C + head * hd:i * C + (head + 1) * hd]
                       for i in range(3))
            got[0, w, :, head * hd:(head + 1) * hd] = two_pass_emulated(
                q, k, v, (rpb[head] + m[w]).astype(np.float32), hd ** -0.5,
                parts, scale_after=True)
    row = np.abs(ref).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(row, 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() >= 0.9
