"""K1's long-window tensor-core route (`csrc/window_attention_tc_long.cu`,
bf16 with 144 < N <= 352: FIBER's 18 x 18 windows at 576^2, N = 324), on
the CPU: the route rule, the kernel caps of K1 against those of K2, K3 and
K4, the plan of the kernel's (nW h, row blocks, S) grid at the FIBER-Base
576^2 stages, and a numpy emulation of the kernel's two-pass order of work
against the plain version in bf16.  The kernel itself is held against the
plain version on a CUDA device in tests/test_torch_kernels.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fiber_torch.config import task_finetune_caption_mle
from fiber_torch.ops import window_attention as twa
from torch_long_attention import bf16, two_pass_emulated

torch.set_num_threads(1)

CSRC = Path(twa.__file__).resolve().parent.parent / "csrc"
SMS = 132                                   # an H100 SXM


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [144, 145, 196, 256, 324, 352, 353])
def test_fwd_route_around_the_long_windows(N, dtype, hd):
    """bf16 at hd <= 64: "tc" to N = 144, "tc_long" to N = 352, the CUDA
    cores beyond; fp32 at hd <= 64 "f32_tiled" (register-tiled CUDA cores)
    to N = 352; hd = 128 always on the older CUDA-core kernel.  K4 takes
    K1's route (its long-window and fp32 kernels run K1's routines)."""
    route = twa._fwd_route(dtype, N, hd)
    if dtype == torch.bfloat16 and hd <= 64 and N <= 144:
        assert route == "tc"
    elif dtype == torch.bfloat16 and hd <= 64 and N <= 352:
        assert route == "tc_long"
    elif dtype == torch.float32 and hd <= 64 and N <= 352:
        assert route == "f32_tiled"
    else:
        assert route == "cuda_core"
    assert twa._heads_route(dtype, N, hd) == route


def test_caps_by_kernel():
    """K1, K2, K3 and K4 all take N <= 352 and raise beyond it: the
    CUDA-core K1, K3 and K4 through a second attend_head instance of 11 key
    chunks beyond the 8-chunk instance's 256, the fp32 K2 through its row
    and column kernels of 11 chunks."""
    assert twa._LONG_MAX_N == 352 and not hasattr(twa, "_MAX_N")
    for N in (256, 324, 352):
        twa._check_head_dims(N, 32)
    with pytest.raises(ValueError):
        twa._check_head_dims(353, 32)
    common = (CSRC / "window_attention_common.cuh").read_text()
    chunks = dict(re.findall(r"constexpr int (k\w*KeyChunks) = (\d+);", common))
    assert 32 * int(chunks["kMaxKeyChunks"]) == 256
    assert 32 * int(chunks["kLongKeyChunks"]) == twa._LONG_MAX_N
    assert "int KC = kMaxKeyChunks" in common
    for src in ("window_attention.cu", "window_attention_heads.cu",
                "swin_stage.cu"):
        text = (CSRC / src).read_text()
        assert "32 * kLongKeyChunks" in text, src
        assert "<T, HD, kLongKeyChunks>" in text, src
    k2 = (CSRC / "window_attention_bwd.cu").read_text()
    assert 32 * int(re.search(r"kLongChunks = (\d+);", k2).group(1)) == \
        twa._LONG_MAX_N
    assert "N > 32 * kLongChunks" in k2


def test_long_kernel_limits_are_the_plans():
    head = (CSRC / "window_attention_tc_long.cuh").read_text()
    assert int(re.search(r"kLongMaxNP = (\d+);", head).group(1)) == \
        twa._LONG_MAX_N
    assert int(re.search(r"kLongMaxWarps = (\d+);", head).group(1)) == \
        twa._LONG_MAX_WARPS
    assert int(re.search(r"kKeyBlock = (\d+);", head).group(1)) == \
        twa._KEY_BLOCK
    assert int(re.search(r"kLongMaxThreads = (\d+);", head).group(1)) == \
        32 * twa._LONG_SM_WARPS
    # K2's long-window kernels: 64 query rows a row block on at most 2
    # consumer warpgroups, rings of at most 4 stages
    k2 = (CSRC / "window_attention_bwd_tc_long.cu").read_text()
    assert int(re.search(r"kRowMaxParts = (\d+);", k2).group(1)) == \
        twa._BWD_ROW_MAX_PARTS
    assert int(re.search(r"kMaxStages = (\d+);", k2).group(1)) == \
        twa._BWD_MAX_STAGES
    assert "kRows = kKeyBlock;" in k2 and twa._BWD_ROWS == twa._KEY_BLOCK
    # the layout at N = 324, hd = 32: R = 64 bias rows (88,064 bytes), two
    # buffers of K, V (336 x 40 bf16 each) and q (64 x 40): 205,824 bytes;
    # then the parts' exchange: 2 P.V accumulators and 3 (max, sum) a row
    assert twa._fwd_long_smem_bytes(324, 32, 64, 1) == 205824 + 512
    assert twa._fwd_long_smem_bytes(324, 32, 64, 3) == 205824 + 16384 + 1536
    assert twa._fwd_long_smem_bytes(324, 32, 96, 1) > twa._MAX_SMEM


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("N", [145, 196, 256, 324, 352])
def test_heads_route_takes_the_long_windows(N, hd):
    """K4 in bf16 beyond N = 144 runs on "tc_long" (K1's long-window
    routine on per-head rows), at every head dim the tensor cores take;
    fp32 runs K1's fp32 routine, bf16 at hd = 128 the CUDA cores."""
    assert twa._heads_route(torch.bfloat16, N, hd) == "tc_long"
    assert twa._heads_route(torch.float32, N, hd) == "f32_tiled"
    assert twa._heads_route(torch.bfloat16, N, 128) == "cuda_core"
    assert twa._heads_route(torch.bfloat16, 144, hd) == "tc"


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_every_long_window_has_a_plan(hd):
    for N in range(145, twa._LONG_MAX_N + 1):
        R, parts, S, per_sm = twa._long_plan(4, 4, 16, N, hd, SMS)
        assert R % 16 == 0 and 16 <= R <= 16 * twa._LONG_MAX_WARPS
        assert 1 <= parts <= twa._LONG_MAX_PARTS
        assert parts == 1 or R // 16 * parts <= twa._LONG_PART_WARPS
        assert parts <= twa._up16(N) // 16          # every part has a key
        assert twa._fwd_long_smem_bytes(N, hd, R, parts) <= twa._MAX_SMEM
        assert per_sm >= 1 and 1 <= S <= 4


CAPTION = task_finetune_caption_mle()
STAGES_576 = [((CAPTION.stage_resolution(s)[0]
                // CAPTION.derived_window_size) ** 2, CAPTION.swin_num_heads[s])
              for s in range(4)]


def test_576_stages():
    """At 576^2 the window is 18 (image_size // 32): N = 324 at every
    stage, 64 / 16 / 4 / 1 windows."""
    assert CAPTION.derived_window_size == 18
    assert STAGES_576 == [(64, 4), (16, 8), (4, 16), (1, 32)]


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("B", [1, 4, 20])
def test_long_plan_at_the_576_stages(B, stage):
    """The plan's R, parts and S fit a block's shared memory and fill the
    grid: at N = 324, hd = 32 it takes R = 64 (6 row blocks) on 3 warps a
    slab (12 warps, one block per SM), and its S is within 1/8 of the
    fewest waves x batch elements a block."""
    nW, h = STAGES_576[stage]
    N, hd = 324, 32
    R, parts, S, per_sm = twa._long_plan(B, nW, h, N, hd, SMS)
    assert (R, parts, per_sm) == (64, 3, 1)
    assert twa._fwd_long_smem_bytes(N, hd, R, parts) <= twa._MAX_SMEM
    blocks = nW * h * -(-N // R) * S
    assert blocks >= SMS
    assert 1 <= S <= B
    cost = lambda s: -(-nW * h * -(-N // R) * s // (SMS * per_sm)) * -(-B // s)
    assert 8 * cost(S) <= 9 * min(cost(s) for s in range(1, B + 1))


def test_long_plan_balances_the_schedulers():
    """Of the R that fit N = 324 (21 slabs) with one warp a slab, R = 80
    has the fewest row blocks (5) but puts two of its 5 warps on one of the
    SM's 4 schedulers; R = 64 (6 row blocks of 4 warps) costs least, then
    R = 48 (7 of 3): the order measured on an H100.  Then the parts: 3
    warps a slab bring R = 64 to 12 warps, still one block an SM (4 would
    reach 16, past `_LONG_PART_WARPS`)."""
    smem = lambda R, p: twa._fwd_long_smem_bytes(324, 32, R, p)
    fits = [R for R in range(16, 129, 16)
            if twa._resident(smem(R, 1), R // 16, twa._LONG_SM_WARPS)]
    assert fits == [16, 32, 48, 64, 80]
    cost = {R: twa._long_cost(324, R, twa._resident(smem(R, 1), R // 16,
                                                     twa._LONG_SM_WARPS))
            for R in fits}
    assert cost[64] < cost[48] < cost[32] and cost[64] < cost[80]
    assert twa._long_rows(324, 32, smem, twa._LONG_MAX_PARTS) == (64, 3, 1)
    assert twa._long_rows(324, 32, smem, 1) == (64, 1, 1)


# ---- the kernel's order of work, emulated in numpy ----------------------
# (tests/torch_long_attention.py: two_pass_emulated)


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("N,h,hd", [(324, 2, 32), (196, 2, 16), (150, 1, 8),
                                    (352, 1, 64)])
def test_two_pass_order_matches_the_plain_version(N, h, hd, shifted, parts):
    """The kernel normalises P before it rounds it, as the plain version
    does, on one warp a slab or on the plan's 3 (the parts' sums meeting
    in a fixed order): in bf16 the two agree to one ulp at each output row's largest
    magnitude (the unit of `chip_smoke.py`'s k1_check rows: P.V sums in
    fp32 in another order on either side, which can move a small output
    that cancels by more than its own ulp), and to the bit in at least 90%
    of the outputs."""
    B, nW = 1, 2
    rng = np.random.default_rng(N + hd + shifted + 10 * parts)
    qkv = bf16(rng.standard_normal((B, nW, N, 3 * h * hd)))
    bias = (rng.standard_normal((nW, h, N, N)) * 0.5).astype(np.float32)
    if shifted:
        bias += np.where(rng.random((nW, 1, N, N)) < 0.3, -100.0, 0.0
                         ).astype(np.float32)
    ref = twa.window_attention_reference(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(bias), h)
    assert ref.dtype == torch.bfloat16
    ref = ref.float().numpy()
    C = h * hd
    got = np.zeros_like(ref)
    for b in range(B):
        for w in range(nW):
            for head in range(h):
                q, k, v = (qkv[b, w, :, i * C + head * hd:i * C + (head + 1) * hd]
                           for i in range(3))
                got[b, w, :, head * hd:(head + 1) * hd] = two_pass_emulated(
                    q, k, v, bias[w, head], hd ** -0.5, parts)
    # one bf16 ulp at the magnitude of each output row
    row = np.abs(ref).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(row, 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() >= 0.9
