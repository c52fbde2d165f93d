"""Window attention: the Swin attention core as one op, with its backward.

`window_attention(qkv, bias, num_heads)` takes the packed projections
(B, nW, N, 3C) and the per-window logit bias (nW, h, N, N) fp32 (relative
position bias plus shift mask, shared over the batch) and returns
(B, nW, N, C) in the input dtype.

On a CPU tensor it runs `window_attention_reference`, the plain PyTorch
version, and autograd differentiates it.  On a CUDA tensor it launches a
hand-written forward kernel (K1), chosen by `_fwd_route` from the dtype and
the shape: bf16 with N <= 144 and hd in {8, 16, 32, 64} (FIBER's windows at
384^2, N = 144) runs the tensor-core kernel of
`fiber_torch/csrc/window_attention_tc.cu` (route "tc"); bf16 with
144 < N <= 352 and the same head dims (FIBER's 18 x 18 windows at 576^2,
N = 324) the tensor-core kernel of
`fiber_torch/csrc/window_attention_tc_long.cu` (route "tc_long"), on a
grid of query-row blocks that `_long_plan` sizes; fp32 with the same head
dims the register-tiled CUDA-core kernel of
`fiber_torch/csrc/window_attention_f32.cu` (route "f32_tiled": the plain
version's operations in its order, 8 query rows a warp; `_f32_plan`); hd =
128 the CUDA-core kernel of `fiber_torch/csrc/window_attention.cu` (route
"cuda_core").  K1, its backward (K2), K3 and K4 all take N <= 352.  When
grad is enabled and an input requires it, K1 runs inside
`_WindowAttentionFunction`, which saves only (qkv, bias) and whose
backward launches K2 (`window_attention_bwd`) on `_bwd_route`'s route:
for bf16 the whole-tile tensor-core kernel of
`fiber_torch/csrc/window_attention_bwd_tc.cu` where its tiles fit (N <=
144), else the row and column kernels of
`fiber_torch/csrc/window_attention_bwd_tc_long.cu` (sized by
`_bwd_long_plan`); for fp32 the split-TF32 row and column kernels of
`fiber_torch/csrc/window_attention_bwd_tf32.cu` ("tc_f32": on the tensor
cores, three TF32 products for each fp32 one, about fp32's accuracy;
`_bwd_f32_plan`), and at hd = 128 the CUDA-core kernels of
`fiber_torch/csrc/window_attention_bwd.cu`, whole tiles or, beyond them,
rows and columns.  On the card each kernel launches or raises: there is
no fallback to the plain version.

`window_attention_heads(q, k, v, bias)` is the same forward on per-head
operands (B, nW, h, N, hd), the layout of the JAX package's `_kernel_call`;
on the card it launches K4, by K1's route rule (`_heads_route`):
`fiber_torch/csrc/window_attention_heads_tc.cu` ("tc"),
`fiber_torch/csrc/window_attention_heads_tc_long.cu` ("tc_long": K1's
long-window routine on per-head rows, planned by `_long_plan`),
`fiber_torch/csrc/window_attention_heads_f32.cu` ("f32_tiled": K1's fp32
routine on per-head rows, `_f32_plan`) or
`fiber_torch/csrc/window_attention_heads.cu` ("cuda_core", hd = 128).
`window_attention_per_head_call` wraps it as `_kernel_call` does: split the
heads of the packed qkv, attend, merge.  No model path calls K4;
`fiber_torch/tools/profile_tail.py` times it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from fiber_torch.utils.profiling import (record_flops,
                                         window_attention_bwd_flops,
                                         window_attention_flops)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128)
# every kernel's window cap: FIBER's 18 x 18 windows at 576^2 (N = 324); the
# CUDA-core attention takes 8 key chunks a lane up to 256 tokens, 11 beyond
_LONG_MAX_N = 352
_BWD_TILE_MAX_N = 256  # K2's fp32 whole-tile kernel
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
_SM_SMEM = 233472   # bytes of shared memory an SM gives its blocks
_BLOCK_SMEM_RESERVED = 1024  # bytes the card keeps per resident block
# the whole-window tensor-core kernels: a 16-row slab's logits (N / 2 fp32
# a thread) in registers, and q, K, V at hd <= 64 beside the bias tile
_TC_MAX_N = 144
_TC_HEAD_DIMS = (8, 16, 32, 64)
# the long-window forward kernels (window_attention_tc_long.cuh): R = 16 x
# warps rows a block, keys 64 a step; __launch_bounds__(512, 1) caps a
# thread at 128 registers, so an SM holds at most 16 of their warps
_LONG_MAX_WARPS = 8
_LONG_SM_WARPS = 16
# K1's warps a 16-row slab ("parts", each a share of the keys), and the
# warps a block may reach with them: on an H100 at N = 324, R = 64 (stage
# 1 of 576^2, B = 4), 1 / 2 / 3 / 4 parts ran 0.41 / 0.34 / 0.31 / 0.34
# ms; 4 or more parts also moved a few outputs 1.5 bf16 ulps from the
# plain version (the rows' sums and P.V meet in another order)
_LONG_MAX_PARTS = 3
_LONG_PART_WARPS = 12
_KEY_BLOCK = 64
# the bf16 long-window backward (window_attention_bwd_tc_long.cu): its row
# kernel's 64 query rows on 1 or 2 consumer warpgroups, its column kernel's
# 64 or 128 keys, each fed by a producer warp through a ring of 2 to 4
# stages
_BWD_ROWS = 64
_BWD_ROW_MAX_PARTS = 2
_BWD_COL_WIDTHS = (64, 128)
_BWD_MAX_STAGES = 4
# the fp32 long-window backward (window_attention_bwd.cu): 8 warps, 16 rows
# or keys a block
_BWD_LONG_ROWS = 16
_BWD_LONG_WARPS = 8
# the fp32 kernels at hd <= 64: the forward (window_attention_f32.cuh) 8
# query rows a warp, the backward's split-TF32 kernels
# (window_attention_bwd_tf32.cu) 16-row slabs, one a warp; up to 8 warps a
# block
_F32_MAX_WARPS = 8
_F32_FWD_ROWS = 8


def _fwd_route(dtype: torch.dtype, N: int, hd: int) -> str:
    """K1's route for one dtype and shape: "tc" (tensor cores) for bf16
    with N <= 144 and hd in {8, 16, 32, 64}, "tc_long" (tensor cores, rows
    split over blocks) for bf16 with 144 < N <= 352 and the same head dims,
    "f32_tiled" (CUDA cores, register-tiled, the plain version's bits) for
    fp32 with those head dims and N <= 352, "cuda_core" at hd = 128."""
    if hd in _TC_HEAD_DIMS:
        if dtype == torch.float32 and N <= _LONG_MAX_N:
            return "f32_tiled"
        if dtype == torch.bfloat16:
            if N <= _TC_MAX_N:
                return "tc"
            if N <= _LONG_MAX_N:
                return "tc_long"
    return "cuda_core"


def _heads_route(dtype: torch.dtype, N: int, hd: int) -> str:
    """K4's route: K1's ("tc", "tc_long" for bf16 at 144 < N <= 352,
    "f32_tiled" for fp32, each at hd in {8, 16, 32, 64}; else
    "cuda_core")."""
    return _fwd_route(dtype, N, hd)


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _op_ld(hd: int) -> int:
    """Row stride (elements) of a staged bf16 operand: max(hd, 16) + 8."""
    return max(hd, 16) + 8


def _bwd_tc_smem_bytes(N: int, hd: int) -> int:
    """Shared memory of `window_attention_bwd_tc.cu` (its `tc_smem_bytes`):
    q, K, V and dO, then the whole fp32 bias and dbias tiles."""
    NP = _up16(N)
    return 4 * _up16(2 * NP * _op_ld(hd)) + 2 * _up16(4 * NP * (NP + 8))


def _bwd_smem_bytes(N: int, hd: int) -> int:
    """Shared memory of `window_attention_bwd.cu`'s whole-tile fp32 kernel
    (its `bwd_smem_bytes`): the (N, N|1) bias and dbias tiles, two staged
    operands, the row statistics and 16 warps' rows."""
    return (2 * _up16(4 * N * (N | 1)) + 2 * _up16(4 * N * (hd + 1))
            + _up16(12 * N) + _up16(4 * 16 * (2 * hd + N)))


def _bwd_long_smem_bytes(N: int, hd: int) -> int:
    """Shared memory of `window_attention_bwd.cu`'s long-window fp32
    kernels (`bwd_long_smem_bytes`): two staged (N, hd) operands, 16 rows
    of an (N, N|1) tile, the row statistics, 8 warps' rows."""
    return (2 * _up16(4 * N * (hd + 1)) + _up16(4 * _BWD_LONG_ROWS * (N | 1))
            + _up16(16 * N) + _up16(4 * _BWD_LONG_WARPS * (2 * hd + N)))


def _bwd_route(dtype: torch.dtype, N: int, hd: int) -> str:
    """K2's route for one dtype and shape.  bf16: "tc"
    (`window_attention_bwd_tc.cu`, whole tiles) where N <= 144 and its
    tiles fit a block, else "tc_long" (`window_attention_bwd_tc_long.cu`,
    row and column kernels) for hd in {8, 16, 32, 64} and N <= 352.  fp32:
    "tc_f32" (`window_attention_bwd_tf32.cu`, split-TF32 row and column
    kernels) for hd in {8, 16, 32, 64}; at hd = 128 "cuda_core"
    (`window_attention_bwd.cu`, whole tiles) where N <= 256 and they fit,
    else "cuda_core_long" (its row and column kernels) where K and V fit a
    block.  Raises on anything else (bf16 hd = 128 beyond the whole tiles,
    N > 352, fp32 hd = 128 at long windows)."""
    if not 1 <= N <= _LONG_MAX_N:
        raise ValueError(f"window attention backward: window of {N} tokens "
                         f"not supported (1..{_LONG_MAX_N})")
    if dtype == torch.float32 and hd in _TC_HEAD_DIMS:
        return "tc_f32"
    if dtype == torch.bfloat16:
        if N <= _TC_MAX_N and _bwd_tc_smem_bytes(N, hd) <= _MAX_SMEM:
            return "tc"
        if hd in _TC_HEAD_DIMS:
            return "tc_long"
        raise ValueError(f"window attention backward: bf16 at hd={hd} takes "
                         f"N <= 144 where its tiles fit a block, got N={N}")
    if N <= _BWD_TILE_MAX_N and _bwd_smem_bytes(N, hd) <= _MAX_SMEM:
        return "cuda_core"
    if _bwd_long_smem_bytes(N, hd) <= _MAX_SMEM:
        return "cuda_core_long"
    raise ValueError(f"window attention backward: N={N}, hd={hd}, {dtype} "
                     f"needs {_bwd_long_smem_bytes(N, hd)} bytes of shared "
                     f"memory, more than a block has")


def _fwd_long_smem_bytes(N: int, hd: int, R: int, parts: int) -> int:
    """Shared memory of one block of `window_attention_tc_long.cu` (its
    `FwdLongLayout`): the R staged bias rows of NP + 8 fp32, two buffers of
    K and V (NP rows) and q (R rows), bf16 rows of max(hd, 16) + 8, then the
    parts' exchange: parts - 1 fp32 P.V accumulators of R x max(hd, 16) and
    every part's (max, sum) of each row."""
    NP, ldo = _up16(N), _op_ld(hd)
    buffer = 2 * _up16(2 * NP * ldo) + _up16(2 * R * ldo)
    return (_up16(4 * R * (NP + 8)) + 2 * buffer
            + _up16(4 * R * (parts - 1) * max(hd, 16)) + _up16(8 * R * parts))


def _up128(n: int) -> int:
    return -(-n // 128) * 128


def _bwd_rows_smem_bytes(N: int, hd: int, parts: int, stages: int) -> int:
    """Shared memory of one block of `window_attention_bwd_tc_long.cu`'s
    row kernel (`RowLayout`): 128 bytes of barriers, its 64 staged bias
    rows and 64 dbias rows of NP + 8 fp32, its K and V (max(hd, 16) bf16
    a row): `stages` ring stages of a key block's 64 rows each, or with
    stages = 0 one element's whole NP rows, then the parts' exchange:
    every part's (max, sum, dot) of each row and, with more than one
    part, one fp32 dq accumulator of 64 x max(hd, 16)."""
    HP = max(hd, 16)
    kv = (stages * 2 * _up128(2 * _KEY_BLOCK * HP) if stages
          else 2 * _up128(2 * _up16(N) * HP))
    return (128 + 2 * _up128(4 * _BWD_ROWS * (_up16(N) + 8)) + kv
            + 16 * _BWD_ROWS * parts + (4 * _BWD_ROWS * HP if parts > 1
                                        else 0))


def _bwd_cols_smem_bytes(N: int, hd: int, Rc: int, stages: int) -> int:
    """The column kernel's (`ColLayout`): 128 bytes of barriers, its Rc
    keys' bias columns for every query row (NP x (Rc + 4) fp32, kept for
    the whole run of batch elements), each consumer warpgroup's round(q *
    scale) of 64 query rows, then `stages` ring stages, each 64 query rows
    of q and dO and the rows' statistics (64 x 4 fp32)."""
    HP = max(hd, 16)
    op = _up128(2 * _KEY_BLOCK * HP)
    return (128 + _up128(4 * _up16(N) * (Rc + 4)) + Rc // 64 * op
            + stages * (2 * op + 16 * _KEY_BLOCK))


def _resident(smem: int, warps: int, sm_warps: int = 64) -> int:
    """Blocks of `warps` warps and `smem` bytes an SM holds at once: its
    233,472 bytes (1,024 reserved per block) and `sm_warps` warps; 0 where
    a block does not fit its 232,448 bytes."""
    if smem > _MAX_SMEM:
        return 0
    return min(_SM_SMEM // (smem + _BLOCK_SMEM_RESERVED), sm_warps // warps)


def _long_cost(N: int, R: int, per_sm: int) -> float:
    """The long-window kernels' cost of R rows a block, one warp a 16-row
    slab, at `per_sm` blocks an SM: ceil(N / R) row blocks over per_sm at
    once, each as slow as its SM's busiest scheduler (an SM has 4) has
    warps.  A warp's slab is latency-bound (on an H100 at N = 324, one
    block per SM: R = 64, 4 warps, 0.391 ms; R = 80, 5 warps, one scheduler
    with two, 0.403; R = 48, 3 warps, 0.476)."""
    warps = R // 16
    return -(-_up16(N) // 16 // warps) * -(-per_sm * warps // 4) / per_sm


def _row_fits(N: int, hd: int, smem) -> list:
    """[(R, blocks per SM)] for the R (16 a warp, up to 8 warps) whose
    block of `smem(R)` bytes fits an SM.  Raises where none does."""
    fits = [(R, _resident(smem(R), R // 16, _LONG_SM_WARPS))
            for R in range(16, 16 * min(_LONG_MAX_WARPS, _up16(N) // 16) + 1,
                           16)]
    fits = [(R, n) for R, n in fits if n]
    if not fits:
        raise ValueError(f"window attention (long windows): no block of "
                         f"N={N}, hd={hd} fits {_MAX_SMEM} bytes of shared "
                         f"memory")
    return fits


def _long_rows(N: int, hd: int, smem, max_parts: int = 1
               ) -> Tuple[int, int, int]:
    """(R, parts, blocks per SM): the R of the least `_long_cost` among
    those whose block of `smem(R, 1)` bytes fits, the largest among
    equals; then the most parts (warps a 16-row slab, each walking a share
    of the keys) up to `max_parts` that keep the block within
    `_LONG_PART_WARPS` warps and its blocks per SM.  Raises where no R
    fits."""
    fits = _row_fits(N, hd, lambda R: smem(R, 1))
    R, per_sm = min(fits, key=lambda f: (_long_cost(N, f[0], f[1]), -f[0]))
    parts = max(p for p in range(1, min(max_parts, _up16(N) // 16) + 1)
                if p == 1 or (R // 16 * p <= _LONG_PART_WARPS and _resident(
                    smem(R, p), R // 16 * p, _LONG_SM_WARPS) == per_sm))
    return R, parts, per_sm


def _long_plan(B: int, nW: int, h: int, N: int, hd: int, sms: int
               ) -> Tuple[int, int, int, int]:
    """(R, parts, S, blocks per SM) of the long-window K1's (ceil(N / R),
    nW h, S) grid of R / 16 x parts warps: `_long_rows` on its shared
    memory, and S splits of the batch by `_bwd_splits` over the
    ceil(N / R) nW h blocks."""
    R, parts, per_sm = _long_rows(
        N, hd, lambda R, p: _fwd_long_smem_bytes(N, hd, R, p),
        _LONG_MAX_PARTS)
    return (R, parts, _bwd_splits(B, nW * -(-N // R), h, sms, per_sm),
            per_sm)


def _bwd_long_plan(B: int, nW: int, h: int, N: int, hd: int, sms: int
                   ) -> Tuple[int, int, int, int, int, int, int]:
    """(R, parts, stages, S, Rc, S', stages') of the bf16 long-window K2.
    The row kernel: R = 64 query rows a block, the most consumer
    warpgroups (`parts`, each a share of the key blocks) whose block fits
    one to an SM (the bias and dbias rows take most of its shared memory),
    with each element's K and V resident (stages = 0: each key block
    copied once for both passes) where they fit, else the most ring
    stages.  The column kernel: of Rc in (64, 128) keys and 2 to 4
    stages, the most consumer warpgroups an SM holds (resident blocks x
    Rc / 64), then the most blocks (on an H100 at N = 324, hd = 32, stage
    1 of 576^2, B = 8, `chip_smoke.py`'s `k2_long_rows`: two blocks of 64
    keys and 2 stages ran the column kernel in 0.570-0.578 ms, one of 128
    keys and 2-4 stages in 0.586-0.588; the row kernel with K and V
    resident 0.886-0.899, in a ring of 2-4 stages 1.018-1.120), then the
    most stages.  Each kernel's batch splits by `_bwd_splits` over its
    grid."""
    rows = [(p, st) for p in range(_BWD_ROW_MAX_PARTS, 0, -1)
            for st in (0,) + tuple(range(_BWD_MAX_STAGES, 1, -1))
            if _resident(_bwd_rows_smem_bytes(N, hd, p, st), 4 * p + 1)]
    if not rows or not _BWD_ROWS * 2 < N <= _LONG_MAX_N:
        raise ValueError(f"window attention backward (long windows): N={N}, "
                         f"hd={hd} does not fit the row kernel")
    parts, stages = rows[0]
    nqb = -(-N // _KEY_BLOCK)
    cols = []
    for Rc in _BWD_COL_WIDTHS:
        for st in range(2, min(_BWD_MAX_STAGES, 2 * nqb) + 1):
            # __launch_bounds__ keeps two 64-key blocks' registers, or
            # one 128-key block's, within an SM's
            per_sm = min(_resident(_bwd_cols_smem_bytes(N, hd, Rc, st),
                                   Rc // 16 + 1), 128 // Rc)
            if per_sm:
                cols.append((per_sm * Rc // 64, per_sm, st, Rc))
    groups, per_sm_c, col_stages, Rc = max(cols)
    return (_BWD_ROWS, parts, stages,
            _bwd_splits(B, nW * -(-N // _BWD_ROWS), h, sms, 1),
            Rc, _bwd_splits(B, nW * -(-N // Rc), h, sms, per_sm_c),
            col_stages)


def _bwd_fp32_long_plan(B: int, nW: int, h: int, N: int, hd: int, sms: int
                        ) -> int:
    """S of the fp32 long-window K2, both its kernels on a (ceil(N / 16),
    nW h, S) grid of 8-warp blocks."""
    per_sm = _resident(_bwd_long_smem_bytes(N, hd), _BWD_LONG_WARPS)
    return _bwd_splits(B, nW * -(-N // _BWD_LONG_ROWS), h, sms, max(per_sm, 1))


def _f32_warps(N: int, hd: int, per_sm, rows: int = 16) -> Tuple[int, int]:
    """(warps, blocks per SM) of an fp32 kernel whose blocks of `warps`
    warps take `rows` query rows (or keys) each, `per_sm[warps - 1]` of
    them an SM at once (the CUDA occupancy API's count for the kernel as
    built, 0 where none fits): of the cuts of the N rows into blocks of at
    most 8 warps, those whose SM runs within 1/8 of the most warps' worth
    of rows at once (blocks an SM times the busy warps of a block on
    average), then the fewest blocks (each stages the element's whole K
    and V), then the most warps.  On an H100 (hd = 32, each width forced
    in turn) this takes the fastest of the backward's row and column
    widths at N = 49, 144 and 324, where the most warps or the fewest
    blocks alone miss by 5-30%.  Raises where no block fits."""
    units = -(-N // rows)
    cuts = []
    for warps in range(1, min(_F32_MAX_WARPS, units) + 1):
        blocks = -(-units // warps)
        if per_sm[warps - 1] > 0:
            cuts.append((per_sm[warps - 1] * units / blocks, blocks, warps,
                         per_sm[warps - 1]))
    if not cuts:
        raise ValueError(f"window attention (fp32): no block of N={N}, "
                         f"hd={hd} fits an SM")
    most = max(c[0] for c in cuts)
    _, _, warps, blocks_sm = min((c for c in cuts if 8 * c[0] >= 7 * most),
                                 key=lambda c: (c[1], -c[2]))
    return warps, blocks_sm


def _f32_plan(B: int, nW: int, h: int, N: int, hd: int, sms: int, per_sm
              ) -> Tuple[int, int, int]:
    """(warps, S, blocks per SM) of the fp32 forward (K1's and K4's
    `f32_tiled`) on its (ceil(N / 8 warps), nW h, S) grid: `_f32_warps` at
    8 query rows a warp on `per_sm` (its blocks an SM by width, from
    `_f32_occupancy` on the card), and S splits of the batch by
    `_bwd_splits`."""
    _check_f32(N, hd)
    warps, blocks_sm = _f32_warps(N, hd, per_sm, _F32_FWD_ROWS)
    blocks = -(-N // (_F32_FWD_ROWS * warps))
    return warps, _bwd_splits(B, nW * blocks, h, sms, blocks_sm), blocks_sm


def _bwd_f32_plan(B: int, nW: int, h: int, N: int, hd: int, sms: int,
                  per_sm_rows, per_sm_cols) -> Tuple[int, int, int, int]:
    """(W, S, W', S') of the fp32 K2 (`tc_f32`): the row kernel's 16-row
    slabs a block and batch splits, the column kernel's 16-key slabs a
    block and splits, each by `_f32_warps` on its blocks an SM by width
    (`per_sm_rows`, `per_sm_cols`, from `_f32_occupancy` on the card; the
    row kernel's dbias rows grow with W) and `_bwd_splits` over its
    grid."""
    _check_f32(N, hd)
    slabs = -(-N // 16)
    W, per_r = _f32_warps(N, hd, per_sm_rows)
    Wc, per_c = _f32_warps(N, hd, per_sm_cols)
    return (W, _bwd_splits(B, nW * -(-slabs // W), h, sms, per_r),
            Wc, _bwd_splits(B, nW * -(-slabs // Wc), h, sms, per_c))


@functools.lru_cache(maxsize=None)
def _f32_occupancy(name: str, N: int, hd: int, device: int, *kernel: int
                   ) -> Tuple[int, ...]:
    """Blocks an SM holds of library `name`'s fp32 kernel at N, hd with 1
    ... 8 warps a block, by the CUDA occupancy API on the kernel as built
    (its registers and shared memory; 0 where none fits): K1's
    `window_attention_f32`, K4's `window_attention_heads_f32`, or K2's
    `window_attention_bwd_tf32` with `kernel` 0 (rows) or 1 (columns)."""
    _check_f32(N, hd)
    f = getattr(_long_lib(name), f"fiber_{name}_blocks_per_sm")
    with torch.cuda.device(device):
        return tuple(max(f(N, hd, w, *kernel), 0)
                     for w in range(1, _F32_MAX_WARPS + 1))


def _bwd_f32_card_plan(B: int, nW: int, h: int, N: int, hd: int,
                       device: torch.device) -> Tuple[int, int, int, int]:
    """`_bwd_f32_plan` on the card `device` at its SMs and its kernels'
    occupancy."""
    i = device.index or 0
    name = "window_attention_bwd_tf32"
    return _bwd_f32_plan(
        B, nW, h, N, hd,
        torch.cuda.get_device_properties(i).multi_processor_count,
        _f32_occupancy(name, N, hd, i, 0), _f32_occupancy(name, N, hd, i, 1))


def _check_f32(N: int, hd: int) -> None:
    if hd not in _TC_HEAD_DIMS or not 1 <= N <= _LONG_MAX_N:
        raise ValueError(f"window attention (fp32): N={N}, "
                         f"hd={hd} not supported (N <= {_LONG_MAX_N}, hd in "
                         f"{_TC_HEAD_DIMS})")


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, nW, N, h * hd) -> (B, nW, h, N, hd)."""
    B, nW, N, C = x.shape
    return x.reshape(B, nW, N, num_heads, C // num_heads).transpose(2, 3)


def window_attention_heads_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, bias: torch.Tensor
                                     ) -> torch.Tensor:
    """Plain version on per-head (B, nW, h, N, hd) operands (K4's): q
    scaled in the input dtype before the product, fp32 logits plus the fp32
    bias, fp32 softmax, probabilities cast to the input dtype, then P.V.
    (float64 inputs stay float64 throughout.)"""
    scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    with torch.autocast(q.device.type, enabled=False):
        attn = torch.matmul((q * scale).to(acc), k.to(acc).transpose(-1, -2))
        attn = attn + bias[None].to(acc)
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        return torch.matmul(attn, v)


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """Plain version on the packed (B, nW, N, 3C) projections (K1's):
    `window_attention_heads_reference` on per-head views."""
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = (_split_heads(t, num_heads) for t in qkv.split(C, dim=-1))
    out = window_attention_heads_reference(q, k, v, bias)
    return out.transpose(2, 3).reshape(B, nW, N, C)


def window_attention_bwd_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                   dout: torch.Tensor, num_heads: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward of `window_attention_reference`: (dqkv, dbias).

    The forward's probabilities are recomputed as the forward computes
    them; every product accumulates in fp32 (float64 for float64 inputs)
    and P and dS are rounded to the input dtype before their products (the
    steps of K2 and of the JAX package's backward kernel).  dqkv is in the
    input dtype, dbias (nW, h, N, N) fp32, summed over the batch."""
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    hd = C // h
    scale = hd ** -0.5
    dt = qkv.dtype

    acc = torch.promote_types(dt, torch.float32)
    with torch.autocast(qkv.device.type, enabled=False):
        q, k, v = (_split_heads(t, h) for t in qkv.split(C, dim=-1))
        k, v = k.to(acc), v.to(acc)
        do = _split_heads(dout, h).to(acc)
        logits = torch.matmul((q * scale).to(acc), k.transpose(-1, -2))
        p = torch.softmax(logits + bias[None].to(acc), dim=-1)
        dv = torch.matmul(p.to(dt).to(acc).transpose(-1, -2), do)
        dp = torch.matmul(do, v.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dbias = ds.sum(0).to(torch.promote_types(bias.dtype, torch.float32))
        dsr = ds.to(dt).to(acc)
        dq = torch.matmul(dsr, k) * scale
        dk = torch.matmul(dsr.transpose(-1, -2), q.to(acc)) * scale
    dqkv = torch.cat([t.to(dt).transpose(2, 3).reshape(B, nW, N, C)
                      for t in (dq, dk, dv)], dim=-1)
    return dqkv, dbias


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The forward kernel's library, built on first use, with its C
    signatures."""
    from fiber_torch.kernels import _build
    lib = _build.load("window_attention")
    lib.fiber_window_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.fiber_window_attention_fwd.restype = ctypes.c_int
    lib.fiber_window_attention_smem_bytes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fiber_window_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


# K2's whole-tile kernels, by route: the library of each
_BWD_LIBS = {"tc": "window_attention_bwd_tc", "cuda_core": "window_attention_bwd"}


# The kernels on the (nW h, S) grid, by library: K2's whole-tile kernels
# and the forward's tensor-core kernels.  Each has a C entry taking its tensors'
# pointers, then B, nW, N, h, hd, the bias window stride, the scale, the
# splits and the stream, and `fiber_<library>_smem_bytes` and
# `fiber_<library>_blocks_per_sm` taking (N, hd).  Library -> (entry,
# pointers).
_SPLIT_ENTRIES = {
    "window_attention_bwd": ("fiber_window_attention_bwd", 6),
    "window_attention_bwd_tc": ("fiber_window_attention_bwd_tc", 6),
    "window_attention_tc": ("fiber_window_attention_tc_fwd", 3),
    "window_attention_heads_tc": ("fiber_window_attention_heads_tc_fwd", 5)}


@functools.lru_cache(maxsize=None)
def _split_lib(name: str) -> ctypes.CDLL:
    """The library `name` of `_SPLIT_ENTRIES`, built on first use, with its
    C signatures."""
    from fiber_torch.kernels import _build
    lib = _build.load(name)
    entry, pointers = _SPLIT_ENTRIES[name]
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for what, restype in (("smem_bytes", ctypes.c_longlong),
                          ("blocks_per_sm", ctypes.c_int)):
        f = getattr(lib, f"fiber_{name}_{what}")
        f.argtypes = [ctypes.c_int, ctypes.c_int]
        f.restype = restype
        if name == "window_attention_bwd":      # and its long-window kernels
            f = getattr(lib, f"fiber_window_attention_bwd_long_{what}")
            f.argtypes = [ctypes.c_int, ctypes.c_int]
            f.restype = restype
    if name == "window_attention_bwd":
        lib.fiber_window_attention_bwd_long.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
        lib.fiber_window_attention_bwd_long.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _split_plan(name: str, dtype: torch.dtype, N: int, hd: int, device: int
                ) -> Tuple[int, int]:
    """(SMs, resident blocks per SM) of the kernel of library `name` for
    one shape on one card.  Raises where the shape does not fit a block."""
    lib = _split_lib(name)
    smem = getattr(lib, f"fiber_{name}_smem_bytes")(N, hd)
    if smem < 0:
        raise ValueError(f"{name}: N={N}, hd={hd} does not fit the kernel's "
                         f"registers (N <= 144) or head dims")
    _check_smem(smem, N, hd, dtype, name)
    per_sm = getattr(lib, f"fiber_{name}_blocks_per_sm")(N, hd)
    if per_sm < 1:
        raise RuntimeError(f"{name}: no block of N={N}, hd={hd}, {dtype} "
                           f"fits an SM ({per_sm})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms, per_sm


def _launch_fwd_tc(name: str, tensors: Tuple[torch.Tensor, ...], B: int,
                   nW: int, N: int, h: int, hd: int, sw: int) -> int:
    """Launch the forward tensor-core kernel of library `name` on `tensors`
    (its operands, the bias and the output, on one device) at
    `_bwd_splits`' batch splits.  It copies 16-byte chunks: raises where a
    tensor does not start on a 16-byte boundary, and where the launch
    fails.  Returns the splits."""
    _check_aligned(name, tensors)
    dev = tensors[0].device
    sms, per_sm = _split_plan(name, tensors[0].dtype, N, hd, dev.index or 0)
    splits = _bwd_splits(B, nW, h, sms, per_sm)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_split_lib(name), _SPLIT_ENTRIES[name][0])(
            *(t.data_ptr() for t in tensors), B, nW, N, h, hd, sw,
            hd ** -0.5, splits, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return splits


@functools.lru_cache(maxsize=None)
def _long_lib(name: str) -> ctypes.CDLL:
    """A planned library, built on first use, with its C signatures: the
    long-window K1 `window_attention_tc_long`, K4
    `window_attention_heads_tc_long` and K2 `window_attention_bwd_tc_long`,
    and the fp32 K1 `window_attention_f32`, K4 `window_attention_heads_f32`
    and K2 `window_attention_bwd_tf32` (pointers, B, nW, N, h, hd, the bias
    window stride, the scale, then ints of its plan (K2's then the kernels
    to launch) and the stream); `fiber_<name>_smem_bytes` and
    `_blocks_per_sm` take (N, hd, R, parts); the bf16 K2's (N, hd, width,
    stages, kernel): the row kernel (0) `width` parts, the column kernel
    (1) `width` keys; the fp32 forward's (N, hd, warps); the fp32 K2's (N,
    hd, warps, kernel)."""
    from fiber_torch.kernels import _build
    lib = _build.load(name)
    pointers, plan, sizes, entry = {
        "window_attention_tc_long": (3, 3, 4, "_fwd"),
        "window_attention_heads_tc_long": (5, 3, 4, "_fwd"),
        "window_attention_bwd_tc_long": (7, 8, 5, ""),
        "window_attention_f32": (3, 2, 3, "_fwd"),
        "window_attention_heads_f32": (5, 2, 3, "_fwd"),
        "window_attention_bwd_tf32": (7, 5, 4, "")}[name]
    fn = getattr(lib, f"fiber_{name}{entry}")
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                   + [ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * plan
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for what, restype in (("smem_bytes", ctypes.c_longlong),
                          ("blocks_per_sm", ctypes.c_int)):
        f = getattr(lib, f"fiber_{name}_{what}")
        f.argtypes = [ctypes.c_int] * sizes
        f.restype = restype
    return lib


def _check_aligned(name: str, tensors) -> None:
    """The tensor-core kernels copy 16-byte chunks: raises where a tensor
    does not start on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} copies 16-byte chunks: every operand must "
                         f"start on a 16-byte boundary")


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(
        t.device.index or 0).multi_processor_count


def _launch_fwd_tc_long(name: str, tensors: Tuple[torch.Tensor, ...],
                        B: int, nW: int, N: int, h: int, hd: int, sw: int
                        ) -> Tuple[int, int, int]:
    """Launch the long-window forward of library `name` (K1's
    `window_attention_tc_long` or K4's `window_attention_heads_tc_long`)
    on `tensors` (its operands, the bias and the output) at `_long_plan`'s
    rows, parts and splits: the two share the layout of a block's shared
    memory (`_fwd_long_smem_bytes`).  Raises where a tensor does not start
    on a 16-byte boundary, and where the launch fails.  Returns (R, parts,
    S)."""
    _check_aligned(name, tensors)
    R, parts, splits, _ = _long_plan(B, nW, h, N, hd, _sms(tensors[0]))
    with torch.cuda.device(tensors[0].device):
        err = getattr(_long_lib(name), f"fiber_{name}_fwd")(
            *(t.data_ptr() for t in tensors), B, nW, N, h, hd, sw,
            hd ** -0.5, R, parts, splits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return R, parts, splits


def _launch_fwd_f32(name: str, tensors: Tuple[torch.Tensor, ...], B: int,
                    nW: int, N: int, h: int, hd: int, sw: int
                    ) -> Tuple[int, int]:
    """Launch the fp32 forward of library `name` (K1's
    `window_attention_f32` or K4's `window_attention_heads_f32`) on
    `tensors` (its operands, the bias and the output) at `_f32_plan`'s
    warps and splits.  Raises where a tensor does not start on a 16-byte
    boundary, and where the launch fails.  Returns (rows a block, S)."""
    _check_aligned(name, tensors)
    dev = tensors[0].device.index or 0
    warps, splits, _ = _f32_plan(B, nW, h, N, hd, _sms(tensors[0]),
                                 _f32_occupancy(name, N, hd, dev))
    with torch.cuda.device(tensors[0].device):
        err = getattr(_long_lib(name), f"fiber_{name}_fwd")(
            *(t.data_ptr() for t in tensors), B, nW, N, h, hd, sw,
            hd ** -0.5, warps, splits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return _F32_FWD_ROWS * warps, splits


def _bwd_splits(B: int, nW: int, h: int, sms: int, per_sm: int) -> int:
    """S, the number of splits of the batch for the (nW h, S) grid of K2
    and of the forward's tensor-core kernels.

    Block (w h + head, s) runs about B / S batch elements in turn, and the
    card runs sms * per_sm blocks at once, so a grid of nW h S blocks
    takes about ceil(nW h S / slots) waves of ceil(B / S) elements each.
    S is the fewest splits whose waves times elements is within 1/8 of
    the least: every split past the first adds a block's fixed costs (in
    K2 also an (nW, h, N, N) fp32 partial to write and sum; in the
    forward one more staging of the bias tile), so where the count ties
    (128 blocks, one wave of 24 elements, against 256 blocks, two waves
    of 12) the fewer splits are the faster."""
    if B <= 1:
        return 1
    units = nW * h
    slots = max(1, sms * per_sm)
    cost = {s: -(-units * s // slots) * -(-B // s) for s in range(1, B + 1)}
    best = min(cost.values())
    return min(s for s, c in cost.items() if 8 * c <= 9 * best)


@functools.lru_cache(maxsize=None)
def _heads_lib() -> ctypes.CDLL:
    """The per-head forward kernel's library (K4), built on first use."""
    from fiber_torch.kernels import _build
    lib = _build.load("window_attention_heads")
    lib.fiber_window_attention_heads_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.fiber_window_attention_heads_fwd.restype = ctypes.c_int
    lib.fiber_window_attention_heads_smem_bytes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fiber_window_attention_heads_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_head_dims(N: int, hd: int) -> None:
    """The head dims the kernels build, and a window of at most
    `_LONG_MAX_N` tokens, the cap of K1, K2, K3 and K4."""
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported ({_HEAD_DIMS})")
    if not 1 <= N <= _LONG_MAX_N:
        raise ValueError(f"window of {N} tokens not supported "
                         f"(1..{_LONG_MAX_N})")


def _bias_window_stride(bias: torch.Tensor, nW: int, h: int, N: int) -> int:
    """The window stride of a (nW, h, N, N) fp32 bias: 0 (broadcast) or
    h N N.  Raises on any other layout."""
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if tuple(bias.shape) != (nW, h, N, N):
        raise ValueError(f"bias must be {(nW, h, N, N)}, got "
                         f"{tuple(bias.shape)}")
    # the window axis may be broadcast (stride 0); each window is contiguous
    sw = bias.stride(0) if nW > 1 else 0
    if not bias[0].is_contiguous() or sw not in (0, h * N * N):
        raise ValueError(f"bias strides {bias.stride()} not supported")
    return sw


def _check_inputs(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int
                  ) -> Tuple[int, int, int, int, int, int]:
    """What K1 and K2 take; returns (B, nW, N, h, hd, bias window
    stride).  Raises on anything else."""
    if not qkv.is_cuda or bias.device != qkv.device:
        raise ValueError(f"qkv and bias must be on one CUDA device, got "
                         f"{qkv.device} and {bias.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype {qkv.dtype} not supported "
                        f"(float32 or bfloat16)")
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, nW, N, 3C), got {tuple(qkv.shape)}")
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads:
        raise ValueError(f"C={C} not divisible by num_heads={num_heads}")
    hd = C // num_heads
    _check_head_dims(N, hd)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    sw = _bias_window_stride(bias, nW, num_heads, N)
    return B, nW, N, num_heads, hd, sw


def _check_smem(smem: int, N: int, hd: int, dtype: torch.dtype,
                what: str) -> None:
    if smem > _MAX_SMEM:
        raise ValueError(f"{what}: N={N}, hd={hd}, {dtype} needs {smem} "
                         f"bytes of shared memory, more than a block has")


def window_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Launch the forward kernel (K1) on the route `_fwd_route` gives.
    Raises on anything it does not take."""
    B, nW, N, h, hd, sw = _check_inputs(qkv, bias, num_heads)
    route = _fwd_route(qkv.dtype, N, hd)
    if route == "cuda_core":
        lib = _lib()
        code = _DTYPE_CODES[qkv.dtype]
        _check_smem(lib.fiber_window_attention_smem_bytes(N, hd, code), N,
                    hd, qkv.dtype, "window attention")
    out = torch.empty((B, nW, N, h * hd), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    rows, parts = N, 1             # query rows a block, warps a 16-row slab
    if route == "tc":
        splits = _launch_fwd_tc("window_attention_tc", (qkv, bias, out), B,
                                 nW, N, h, hd, sw)
    elif route == "tc_long":
        rows, parts, splits = _launch_fwd_tc_long(
            "window_attention_tc_long", (qkv, bias, out), B, nW, N, h, hd, sw)
    elif route == "f32_tiled":
        rows, splits = _launch_fwd_f32("window_attention_f32",
                                       (qkv, bias, out), B, nW, N, h, hd, sw)
    else:
        splits = B                 # one block per batch element
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fiber_window_attention_fwd(
                qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, nW, N, h,
                hd, sw, hd ** -0.5, code, stream)
        if err != 0:
            raise RuntimeError(f"window attention kernel launch failed: CUDA "
                               f"error {err}")
    window_attention.launches += 1
    record_flops(out, window_attention_flops(B, nW, N, h, hd))
    window_attention.route_launches[route] += 1
    window_attention.last_splits = splits
    window_attention.last_rows = rows
    window_attention.last_parts = parts
    return out


def window_attention_bwd_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                              dout: torch.Tensor, num_heads: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (K2): (dqkv, dbias (nW, h, N, N) fp32).

    The route is `_bwd_route`'s: bf16 runs the whole-tile tensor-core
    kernel of `csrc/window_attention_bwd_tc.cu` ("tc") or, for the long
    windows, the row and column kernels of
    `csrc/window_attention_bwd_tc_long.cu` ("tc_long"); fp32 the split-TF32
    row and column kernels of `csrc/window_attention_bwd_tf32.cu`
    ("tc_f32"), at hd = 128 the CUDA-core kernels of
    `csrc/window_attention_bwd.cu` ("cuda_core", whole tiles;
    "cuda_core_long", rows and columns).  Each splits the batch over S
    blocks per (window, head) or row block (`_bwd_splits`) and sums the S
    dbias partials in a fixed order.  Raises on anything the kernels do
    not take, and where a launch fails: there is no fallback."""
    B, nW, N, h, hd, sw = _check_inputs(qkv, bias, num_heads)
    if dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise TypeError(f"dout must be {qkv.dtype} on {qkv.device}, got "
                        f"{dout.dtype} on {dout.device}")
    if tuple(dout.shape) != (B, nW, N, h * hd) or not dout.is_contiguous():
        raise ValueError(f"dout must be contiguous {(B, nW, N, h * hd)}, got "
                         f"{tuple(dout.shape)} strides {dout.stride()}")
    route = _bwd_route(qkv.dtype, N, hd)
    if route.startswith("tc"):
        _check_aligned("the tensor-core window attention backward",
                       (qkv, bias, dout))
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nW, h, N, N), dtype=torch.float32,
                        device=qkv.device)
    if B == 0:
        return dqkv, dbias.zero_()
    sms = _sms(qkv)
    if route in _BWD_LIBS:
        name = _BWD_LIBS[route]
        sms, per_sm = _split_plan(name, qkv.dtype, N, hd, qkv.device.index or 0)
        splits = _bwd_splits(B, nW, h, sms, per_sm)
        plan = (splits,)
    elif route == "tc_long":
        name = "window_attention_bwd_tc_long"
        plan = _bwd_long_plan(B, nW, h, N, hd, sms)
        splits = plan[3]
    elif route == "tc_f32":
        name = "window_attention_bwd_tf32"
        plan = _bwd_f32_card_plan(B, nW, h, N, hd, qkv.device)
        splits = plan[1]
    else:
        name = "window_attention_bwd"
        splits = _bwd_fp32_long_plan(B, nW, h, N, hd, sms)
        plan = (splits, splits)
    partials = (torch.empty((splits, nW, h, N, N), dtype=torch.float32,
                            device=qkv.device) if splits > 1 else dbias)
    tensors = [qkv, bias, dout, dqkv, dbias, partials]
    if route in ("tc_long", "tc_f32", "cuda_core_long"):
        # each row's softmax max, sum and rowsum(dP * P), from the row kernel
        # to the column kernel
        tensors.append(torch.empty((B, nW * h, N, 4), dtype=torch.float32,
                                   device=qkv.device))
    if route == "tc_long":
        fn = _long_lib(name).fiber_window_attention_bwd_tc_long
        plan = plan + (_BWD_ROW_KERNEL | _BWD_COL_KERNEL,)
    elif route == "tc_f32":
        fn = _long_lib(name).fiber_window_attention_bwd_tf32
        plan = plan + (_BWD_ROW_KERNEL | _BWD_COL_KERNEL,)
    elif route == "cuda_core_long":
        fn = _split_lib(name).fiber_window_attention_bwd_long
    else:
        fn = getattr(_split_lib(name), _SPLIT_ENTRIES[name][0])
    with torch.cuda.device(qkv.device):
        err = fn(*(t.data_ptr() for t in tensors), B, nW, N, h, hd, sw,
                 hd ** -0.5, *plan, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention backward kernel launch "
                           f"failed ({route}): CUDA error {err}")
    window_attention_bwd.launches += 1
    record_flops(dqkv, window_attention_bwd_flops(B, nW, N, h, hd))
    window_attention_bwd.route_launches[route] += 1
    window_attention_bwd.last_splits = splits
    window_attention_bwd.last_plan = plan[:_BWD_PLAN_LEN.get(route, 9)]
    return dqkv, dbias


# the row and column kernels of K2's "tc_long" and "tc_f32" routes, by
# bit, and the length of each route's plan
_BWD_ROW_KERNEL, _BWD_COL_KERNEL = 1, 2
_BWD_PLAN_LEN = {"tc_long": 7, "tc_f32": 4}


def window_attention_bwd_kernels(qkv: torch.Tensor, bias: torch.Tensor,
                                 dout: torch.Tensor, num_heads: int):
    """K2 on these inputs, where its route runs a row and a column kernel
    (bf16 "tc_long", fp32 "tc_f32"), the two kernels apart: (launch,
    plan), where launch(kernels) runs the row kernel (`_BWD_ROW_KERNEL`,
    with the sum of its dbias partials), the column kernel
    (`_BWD_COL_KERNEL`, on the row statistics the last row launch left) or
    both, on buffers it holds, and returns (dqkv, dbias).  For timing each
    kernel alone; it counts no launches.  Raises where the inputs take
    another route."""
    B, nW, N, h, hd, sw = _check_inputs(qkv, bias, num_heads)
    route = _bwd_route(qkv.dtype, N, hd)
    if route not in _BWD_PLAN_LEN or B == 0:
        raise ValueError(f"K2 at {qkv.dtype}, B={B}, N={N}, hd={hd} runs no "
                         f"row and column kernels (route {route})")
    _check_aligned("the tensor-core window attention backward",
                   (qkv, bias, dout))
    if route == "tc_long":
        name = "window_attention_bwd_tc_long"
        plan = _bwd_long_plan(B, nW, h, N, hd, _sms(qkv))
        splits = plan[3]
    else:
        name = "window_attention_bwd_tf32"
        plan = _bwd_f32_card_plan(B, nW, h, N, hd, qkv.device)
        splits = plan[1]
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nW, h, N, N), dtype=torch.float32, device=qkv.device)
    partials = (torch.empty((splits, nW, h, N, N), dtype=torch.float32,
                            device=qkv.device) if splits > 1 else dbias)
    stats = torch.empty((B, nW * h, N, 4), dtype=torch.float32,
                        device=qkv.device)
    fn = getattr(_long_lib(name), f"fiber_{name}")
    ptrs = [t.data_ptr() for t in (qkv, bias, dout, dqkv, dbias, partials,
                                   stats)]

    def launch(kernels: int):
        with torch.cuda.device(qkv.device):
            err = fn(*ptrs, B, nW, N, h, hd, sw, hd ** -0.5, *plan, kernels,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"window attention backward kernel launch "
                               f"failed ({route}, {kernels}): CUDA error "
                               f"{err}")
        return dqkv, dbias

    return launch, plan


def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         dout: torch.Tensor, num_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward op: plain version on a CPU tensor, K2 on a CUDA one.

    `window_attention_bwd.launches` counts K2's launches,
    `window_attention_bwd.route_launches` the same by route
    (`_bwd_route`), `window_attention_bwd.last_splits` holds the batch
    splits of the last launch (the row kernel's on the long routes) and
    `.last_plan` its whole plan: (S,) on the whole-tile routes, (R, parts,
    stages, S, Rc, S', stages') on "tc_long", (W, S, W', S') on "tc_f32"
    (`_bwd_f32_plan`), (S, S) on "cuda_core_long"."""
    if qkv.is_cuda:
        return window_attention_bwd_cuda(qkv, bias, dout, num_heads)
    return window_attention_bwd_reference(qkv, bias, dout, num_heads)


window_attention_bwd.launches = 0
window_attention_bwd.route_launches = {"tc": 0, "tc_long": 0, "tc_f32": 0,
                                       "cuda_core": 0, "cuda_core_long": 0}
window_attention_bwd.last_splits = 0
window_attention_bwd.last_plan = ()


class _WindowAttentionFunction(torch.autograd.Function):
    """K1 forward, K2 backward; saves (qkv, bias) and no probabilities.
    A broadcast (stride-0) bias gets a per-window gradient, which
    autograd's expand backward then sums."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, bias)
        return window_attention_cuda(qkv, bias, num_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, dout.contiguous(),
                                           ctx.num_heads)
        return (dqkv if ctx.needs_input_grad[0] else None,
                dbias if ctx.needs_input_grad[1] else None, None)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """The op: plain version on a CPU tensor, the kernels on a CUDA one.

    `window_attention.launches` counts the forward kernel's launches,
    `window_attention.route_launches` the same by route (`_fwd_route`),
    `window_attention.last_splits` holds the batch splits of the last
    launch (B on the CUDA-core route, one block per batch element) and
    `window_attention.last_rows` its query rows a block and
    `.last_parts` its warps a 16-row slab (N and 1 on routes "tc" and
    "cuda_core"; 8 warps and 1 on "f32_tiled")."""
    if not qkv.is_cuda:
        return window_attention_reference(qkv, bias, num_heads)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttentionFunction.apply(qkv, bias, num_heads)
    return window_attention_cuda(qkv, bias, num_heads)


window_attention.launches = 0
window_attention.route_launches = {"tc": 0, "tc_long": 0, "f32_tiled": 0,
                                   "cuda_core": 0}
window_attention.last_splits = 0
window_attention.last_rows = 0
window_attention.last_parts = 0


def window_attention_heads_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor
                                ) -> torch.Tensor:
    """Launch the per-head forward kernel (K4) on contiguous (B, nW, h, N,
    hd) operands, on the route `_heads_route` gives.  Raises on anything it
    does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and bias.device == q.device):
        raise ValueError(f"q, k, v and bias must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}, {bias.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, nW, h, N, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must each be contiguous")
    B, nW, h, N, hd = q.shape
    _check_head_dims(N, hd)
    sw = _bias_window_stride(bias, nW, h, N)
    route = _heads_route(q.dtype, N, hd)
    if route == "cuda_core":
        lib = _heads_lib()
        code = _DTYPE_CODES[q.dtype]
        _check_smem(lib.fiber_window_attention_heads_smem_bytes(N, hd, code),
                    N, hd, q.dtype, "per-head window attention")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rows, parts = N, 1             # query rows a block, warps a 16-row slab
    if route == "tc":
        splits = _launch_fwd_tc("window_attention_heads_tc",
                                 (q, k, v, bias, out), B, nW, N, h, hd, sw)
    elif route == "tc_long":
        rows, parts, splits = _launch_fwd_tc_long(
            "window_attention_heads_tc_long", (q, k, v, bias, out), B, nW, N,
            h, hd, sw)
    elif route == "f32_tiled":
        rows, splits = _launch_fwd_f32("window_attention_heads_f32",
                                       (q, k, v, bias, out), B, nW, N, h, hd,
                                       sw)
    else:
        splits = B                 # one block per batch element
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fiber_window_attention_heads_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, nW, N, h, hd, sw, hd ** -0.5, code, stream)
        if err != 0:
            raise RuntimeError(f"per-head window attention kernel launch "
                               f"failed: CUDA error {err}")
    window_attention_heads.launches += 1
    record_flops(out, window_attention_flops(B, nW, N, h, hd))
    window_attention_heads.route_launches[route] += 1
    window_attention_heads.last_splits = splits
    window_attention_heads.last_rows = rows
    window_attention_heads.last_parts = parts
    return out


def window_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The per-head op, forward only: plain version on a CPU tensor, K4 on
    a CUDA one.  `window_attention_heads.launches` counts K4's launches,
    `.route_launches` the same by route and `.last_splits`, `.last_rows`
    and `.last_parts` the plan of the last launch, as for
    `window_attention`."""
    if not q.is_cuda:
        return window_attention_heads_reference(q, k, v, bias)
    return window_attention_heads_cuda(q, k, v, bias)


window_attention_heads.launches = 0
window_attention_heads.route_launches = {"tc": 0, "tc_long": 0,
                                         "f32_tiled": 0, "cuda_core": 0}
window_attention_heads.last_splits = 0
window_attention_heads.last_rows = 0
window_attention_heads.last_parts = 0


def split_heads_qkv(qkv: torch.Tensor, num_heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed (B, nW, N, 3C) -> contiguous per-head q, k, v, each
    (B, nW, h, N, hd): the head-split transpose of `_kernel_call`."""
    B, nW, N, C3 = qkv.shape
    h = num_heads
    x = qkv.reshape(B, nW, N, 3, h, C3 // 3 // h).permute(3, 0, 1, 4, 2, 5)
    x = x.contiguous()
    return x[0], x[1], x[2]


def window_attention_per_head_call(qkv: torch.Tensor, bias: torch.Tensor,
                                   num_heads: int) -> torch.Tensor:
    """The counterpart of the JAX package's `_kernel_call`: split the
    packed qkv into heads, run the per-head op, merge back to (B, nW, N,
    C)."""
    B, nW, N, C3 = qkv.shape
    out = window_attention_heads(*split_heads_qkv(qkv, num_heads), bias)
    return out.transpose(2, 3).reshape(B, nW, N, C3 // 3)
