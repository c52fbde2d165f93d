"""K3's tensor-core route (`csrc/swin_stage_tc.cu`), on the CPU: the route
rule, the per-product tile plan and attention splits at the FIBER-Base
stages, that every shape the route takes fits a block, and a torch
emulation of the kernel's order of work in bf16 against the plain version.
The kernel itself is held against the plain version on a CUDA device in
tests/test_torch_kernels.py; the plain version is held against JAX in
test_torch_swin_stage.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.models.swin import SwinBlock, window_partition
from fiber_torch.ops import swin_stage as tss
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

CSRC = Path(tss.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("N", [4, 16, 49, 144])
def test_k3_route_bf16_tensor_cores(N, hd):
    assert tss._k3_route(torch.bfloat16, N, hd) == "tc"


@pytest.mark.parametrize("N,hd", [(144, 128), (49, 128), (256, 128)])
def test_k3_route_bf16_beyond_the_tiles(N, hd):
    """Neither tensor-core attention routine builds hd = 128 (bf16 beyond
    N = 144 at hd <= 64 takes "tc_long": test_torch_swin_stage_tc_long.py)."""
    assert tss._k3_route(torch.bfloat16, N, hd) == "cuda_core"


@pytest.mark.parametrize("N,hd", [(4, 8), (16, 16), (49, 32), (144, 32),
                                  (144, 64), (256, 128)])
def test_k3_route_fp32_cuda_cores(N, hd):
    assert tss._k3_route(torch.float32, N, hd) == "cuda_core"


def _kernel_constant(name):
    """A constant of the tensor-core K3's shared header (the GEMM and
    LayerNorm phases of swin_stage_tc.cu and swin_stage_tc_long.cu), and
    the header's text."""
    src = (CSRC / "swin_stage_tc.cuh").read_text()
    return src, int(re.search(rf"{name} = (\d+);", src).group(1))


def test_tiles_are_the_kernels():
    """The wrapper's tile table is the kernel's, in the same order (the
    kernel receives indices into it), with the kernel's warp layouts."""
    src, _ = _kernel_constant("kBK")
    body = re.search(r"kTiles\[3\]\[2\] = \{(.*?)\};", src).group(1)
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"\{(\d+), (\d+)\}", body))
    assert tiles == tss._K3_TILES
    warps = re.findall(r"case (\d): gemm_phase<kTiles\[\d\]\[0\], "
                       r"kTiles\[\d\]\[1\], (\d), (\d), EPI>", src)
    warps += re.findall(r"default: gemm_phase<kTiles\[(\d)\]\[0\], "
                        r"kTiles\[\d\]\[1\], (\d), (\d), EPI>", src)
    assert {tiles[int(i)]: (int(wm), int(wn)) for i, wm, wn in warps} == \
        tss._K3_WARPS


def test_tile_bytes():
    """Shared-memory traffic of one k16 step: 128 x 128 moves 2x and
    128 x 64 1.375x what 64 x 64 moves."""
    assert [tss._k3_tile_bytes(t) for t in tss._K3_TILES] == \
        [32768, 22528, 16384]


def test_tc_route_fits_a_block():
    """The block's shared memory, the larger of the GEMM pipeline's and the
    attention routine's, fits for every shape the route takes; at N = 144,
    hd = 32 it is the attention's 156,672 bytes (one block per SM)."""
    _, bk = _kernel_constant("kBK")
    _, stages = _kernel_constant("kStages")
    gemm = stages * (128 + 128) * (bk + 8) * 2 + 2 * 8 * 128
    assert gemm == 83968

    def attend(N, hd):
        np_ = -(-N // 16) * 16
        a16 = lambda x: -(-x // 16) * 16
        return a16(4 * np_ * (np_ + 8)) + 6 * a16(2 * np_ * (max(hd, 16) + 8))

    assert max(attend(144, 32), gemm) == 156672
    assert max(max(attend(N, hd), gemm) for N in range(1, twa._TC_MAX_N + 1)
               for hd in twa._TC_HEAD_DIMS) <= twa._MAX_SMEM


# FIBER-Base 384^2 stages: (H = W, C, heads); window 12, MLP 4C; K3's grid
# on an H100: 132 SMs, one resident block (156,672 bytes of shared memory)
BASE = FiberConfig.base()
STAGES = [(BASE.stage_resolution(s)[0], BASE.stage_dim(s),
           BASE.swin_num_heads[s]) for s in range(4)]
WIN = BASE.derived_window_size
GRID = 132


def test_base_stages():
    assert STAGES == [(96, 128, 4), (48, 256, 8), (24, 512, 16),
                      (12, 1024, 32)]
    assert WIN == 12 and BASE.swin_mlp_ratio == 4


def _plan(stage, B):
    H, C, h = STAGES[stage]
    return tss._k3_plan(B, H, H, C, 4 * C, WIN, h, GRID)


def _products(stage, B):
    """(M, output width) of qkv, proj, fc1 and fc2."""
    H, C, _ = STAGES[stage]
    M = B * H * H
    return {"qkv": (M, 3 * C), "proj": (M, C), "fc1": (M, 4 * C),
            "fc2": (M, C)}


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("B", [1, 4, 16])
def test_tile_plan_covers_every_tile(B, stage):
    """The kernel's loop (block b runs tiles b, b + grid, ...; tile t is
    row tile t % tiles_m, column tile t // tiles_m) reaches every tile of
    every product once, and the tiles cover every output; the attention
    splits are a split of the batch."""
    plan = _plan(stage, B)
    for name, (M, n_out) in _products(stage, B).items():
        BM, BN = plan[name]
        assert (BM, BN) in tss._K3_TILES
        tm, tn = -(-M // BM), -(-n_out // BN)
        assert (tm - 1) * BM < M <= tm * BM
        assert (tn - 1) * BN < n_out <= tn * BN
        seen = [(t % tm, t // tm) for b in range(GRID)
                for t in range(b, tm * tn, GRID)]
        assert sorted(seen) == [(i, j) for i in range(tm) for j in range(tn)]
    assert 1 <= plan["splits"] <= B


def _busy(M, n_out, tile):
    """Share of the grid's tile slots over the product's waves that hold a
    tile."""
    tiles = -(-M // tile[0]) * -(-n_out // tile[1])
    return tiles / (-(-tiles // GRID) * GRID)


@pytest.mark.parametrize("product", ["proj", "fc2"])
def test_tile_plan_fills_the_grid_at_stage3(product):
    """At stage 3 / B = 4 (M = 2304, C = 512) proj and fc2 take one wave of
    72 tiles of 128 x 128 on 132 blocks: no more than half the grid idle
    (64 x 64 would fill 73% of three waves, and ran slower on the card)."""
    M, n_out = _products(2, 4)[product]
    tile = _plan(2, 4)[product]
    assert tile == (128, 128)
    assert _busy(M, n_out, tile) == 72 / 132 >= 0.5


def test_tile_plan_at_the_report_shape():
    """Stage 3 / B = 4 on 132 blocks: 128 x 128 for every product (216
    qkv tiles in two waves, 72 for proj and fc2, 288 for fc1); the
    attention's 64 (window, head) units in 2 splits, as K1's."""
    assert _plan(2, 4) == {"qkv": (128, 128), "proj": (128, 128),
                           "fc1": (128, 128), "fc2": (128, 128), "splits": 2}
    assert _plan(2, 4)["splits"] == twa._bwd_splits(4, 4, 16, GRID, 1)


@pytest.mark.parametrize("product,tile", [("qkv", (128, 128)),
                                          ("proj", (128, 64)),
                                          ("fc1", (128, 128)),
                                          ("fc2", (128, 64))])
def test_tile_plan_at_stage4(product, tile):
    """Stage 4 / B = 4 (M = 576, C = 1024): proj and fc2 fit one wave
    either as 40 tiles of 128 x 128 or as 80 of 128 x 64, and the smaller
    tile moves less shared memory per tile."""
    assert _plan(3, 4)[product] == tile


# ---- the kernel's order of work, emulated in torch -----------------------

def _bf(t):
    """t rounded to bf16, as float32."""
    return t.to(torch.bfloat16).float()


def _rows_token(B, H, W, win, shift):
    """`Rows::token` of swin_stage_common.cuh: row r of the (B, nW, N)
    window order over the grid rolled by -shift -> its token."""
    r = np.arange(B * H * W)
    if win == 0:
        return torch.from_numpy(r)
    N, nWw = win * win, W // win
    nW = (H // win) * nWw
    n, w, b = r % N, (r // N) % nW, r // N // nW
    i = (w // nWw) * win + n // win + shift
    j = (w % nWw) * win + n % win + shift
    i, j = i - H * (i >= H), j - W * (j >= W)
    return torch.from_numpy((b * H + i) * W + j)


def _ln(a, s, b):
    mu = a.mean(-1, keepdim=True)
    var = ((a - mu) ** 2).mean(-1, keepdim=True)
    return (a - mu) * torch.rsqrt(var + 1e-5) * s + b


def _emulated_tc(x, sp, mask, window, h, use_shift):
    """swin_stage_tc.cu's order of work on bf16 values held as float32:
    LN as its own rounded pass (LN1 gathered in window order through the
    row map), the products in fp32 with fp32 epilogues, the logits scaled
    after the fp32 q.k^T plus (rpb + mask) summed once, the softmax by exp2
    of prescaled logits and one reciprocal a row, P rounded, the context
    rounded on store."""
    B, H, W, C = x.shape
    M, hd, N = B * H * W, C // h, window * window
    nW = (H // window) * (W // window)
    log2e = 1.4426950408889634
    p = {k: v.float() for k, v in sp.items()}
    act = x.float().reshape(M, C)
    for j in range(sp["qkv_w"].shape[0]):
        shifted = use_shift and j % 2 == 1
        rows = _rows_token(B, H, W, window, window // 2 if shifted else 0)
        h1 = _bf(_ln(act[rows], p["ln1_s"][j], p["ln1_b"][j]))
        qkv = _bf(h1 @ p["qkv_w"][j].t() + p["qkv_b"][j])
        q, k, v = (t.reshape(B, nW, N, h, hd).transpose(2, 3)
                   for t in qkv.split(C, dim=-1))
        tile = p["rpb"][j][None, None]                     # (1, 1, h, N, N)
        if shifted:
            tile = tile + mask[None, :, None]
        s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + tile
        m = s.amax(-1, keepdim=True) * log2e
        e = torch.exp2(s * log2e - m)
        probs = _bf(e * (1.0 / e.sum(-1, keepdim=True)))
        ctx = _bf(probs @ v).transpose(2, 3).reshape(M, C)
        proj = ctx @ p["proj_w"][j].t() + p["proj_b"][j]
        act[rows] = _bf(act[rows] + _bf(proj))
        h2 = _bf(_ln(act, p["ln2_s"][j], p["ln2_b"][j]))
        hm = h2 @ p["fc1_w"][j].t() + p["fc1_b"][j]
        hm = _bf(0.5 * hm * (1.0 + tss._erf(hm * 2.0 ** -0.5)))
        act = _bf(act + (hm @ p["fc2_w"][j].t() + p["fc2_b"][j]))
    return act.reshape(B, H, W, C)


def _stack(shape, seed):
    """Seeded blocks of one stage (LayerNorms and biases off 1 / 0), stacked
    in bf16, and a bf16 input."""
    B, H, W, C, h, window, n = shape
    gen = torch.Generator().manual_seed(seed)
    blocks = [SwinBlock(C, (H, W), h, window, (window // 2) * (i % 2))
              for i in range(n)]
    with torch.no_grad():
        for blk in blocks:
            for name, prm in blk.named_parameters():
                r = torch.randn(prm.shape, generator=gen)
                prm.copy_(1 + 0.1 * r if name.startswith("norm")
                          and name.endswith("weight") else
                          0.5 * r if "bias_table" in name else 0.05 * r)
    x = torch.randn(B, H, W, C, generator=gen).bfloat16()
    return x, tss.stack_stage(blocks, torch.bfloat16)


def test_rows_token_is_the_rolled_window_partition():
    """The row map gathers the rolled grid in window order."""
    B, H, W, C, win, s = 2, 8, 12, 3, 4, 2
    x = torch.arange(B * H * W * C, dtype=torch.float32).reshape(B, H, W, C)
    want = window_partition(torch.roll(x, (-s, -s), (1, 2)), win)
    got = x.reshape(-1, C)[_rows_token(B, H, W, win, s)]
    torch.testing.assert_close(got, want.reshape(-1, C), rtol=0, atol=0)


# (B, H, W, C, heads, window, blocks): shifted stacks at hd 16, 32 (N = 49)
# and 64, and a one-window stack at hd 8 (the stage-4 layout)
EMULATED = [(2, 8, 8, 32, 2, 4, 3), (1, 14, 14, 64, 2, 7, 2),
            (1, 8, 8, 128, 2, 4, 2), (2, 4, 4, 32, 4, 4, 2)]


@pytest.mark.parametrize("shape", EMULATED)
def test_tc_order_of_work_is_the_plain_versions(shape):
    """The kernel's contract (LN rounded as its own pass, the logits scaled
    after the fp32 product with (rpb + mask) summed first, fp32 epilogues)
    is the plain version's in bf16: within the tolerance the card holds K3
    to (2e-2 of the output's max-abs), mostly to the bit."""
    x, st = _stack(shape, sum(shape))
    assert tss._k3_route(torch.bfloat16, st.window ** 2,
                         shape[3] // shape[4]) == "tc"
    with torch.inference_mode():
        ref = tss.fused_swin_blocks_reference(x, st.params, st.mask,
                                              st.window, st.num_heads,
                                              st.use_shift).float()
        got = _emulated_tc(x, st.params, st.mask, st.window, st.num_heads,
                           st.use_shift)
    err = (got - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err
    assert (got == ref).float().mean().item() >= 0.9
