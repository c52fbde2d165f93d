"""A run of unfused Swin blocks as one op, for inference.

The counterpart of the JAX package's `fiber_tpu/ops/swin_stage.py`.
`fused_swin_blocks(x, sp, mask, window, num_heads, use_shift)` runs n
consecutive Swin blocks (deterministic, no drop-path, no text) over x
(B, H, W, C).  On a CPU tensor it runs `fused_swin_blocks_reference`, the
plain PyTorch version; on a CUDA tensor it launches a hand-written kernel
(K3), all n blocks in one cooperative launch, or raises: there is no
fallback.  `_k3_route` picks the kernel from the dtype and the shape: bf16
with hd in {8, 16, 32, 64} runs on the tensor cores, with N <= 144 (every
FIBER stage at 384^2) the kernel of `fiber_torch/csrc/swin_stage_tc.cu`
(route "tc"), with 144 < N <= 352 (FIBER's 18 x 18 windows at 576^2, N =
324) that of `fiber_torch/csrc/swin_stage_tc_long.cu` (route "tc_long":
the same GEMM and LayerNorm phases, `swin_stage_tc.cuh`, with K1's
long-window attention routine at K3's rounding); both with the tile shapes
and attention splits of `_k3_plan`, the long route also its rows a block
and warps a slab.  fp32, and bf16 at hd = 128, run the CUDA-core kernel of
`fiber_torch/csrc/swin_stage.cu` (route "cuda_core"), which takes N <=
352.  It takes no gradient: with grad enabled and an input that requires
it, it raises.

`stack_block_params` stacks the port's `SwinBlock` modules into the op's
parameters; `stack_stage` does so for consecutive blocks of one stage and
keeps the window, heads, shift and mask beside them (`StageStack`, a
callable); `stack_swin` stacks the leading blocks of each stage of a
`SwinTransformer` and `run_stacks` runs those stacks between the model's own
patch embedding, downsamples and final norm.  The model's own forward stays
per block; K3 is an op that a caller composes with the model's modules
(`chip_smoke.py` drives it over the FIBER-Base trunk and ITC tower).

The TPU kernel's tiling knobs `batch_tile` and `mlp_chunks` (its VMEM
budget) are not part of the contract and are dropped.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fiber_torch.models.swin import (SwinBlock, SwinTransformer,
                                     relative_position_index,
                                     window_partition, window_reverse)
from fiber_torch.ops.window_attention import (_DTYPE_CODES, _LONG_MAX_N,
                                              _LONG_MAX_PARTS,
                                              _LONG_MAX_WARPS, _MAX_SMEM,
                                              _TC_HEAD_DIMS, _TC_MAX_N,
                                              _bwd_splits, _check_head_dims,
                                              _check_smem,
                                              _fwd_long_smem_bytes,
                                              _long_cost, _up16)

STACK_KEYS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
              "ln2_s", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b", "rpb")
# kept in fp32 whatever the activations' dtype; the rest take x's dtype
FP32_KEYS = ("ln1_s", "ln1_b", "ln2_s", "ln2_b", "rpb")


def stack_block_params(blocks: Sequence[SwinBlock], window: int,
                       num_heads: int, use_shift: bool = True,
                       dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, torch.Tensor]:
    """Stack consecutive blocks into the op's parameters: the weights in
    nn.Linear's (out, in) layout and the Linear biases in `dtype` (default:
    the blocks' own), LayerNorm parameters in fp32, each block's relative
    position bias table gathered into a dense (h, N, N) fp32 bias.

    The op shifts stack position j iff j is odd and `use_shift`; a block
    whose own shift differs (a stack starting on a shifted block), a padded
    block, or one whose window, resolution, width or heads differ from the
    stack's raises ValueError."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("no blocks to stack")
    first = blocks[0]
    res, dim = tuple(first.input_resolution), first.dim
    dtype = dtype or first.attn.qkv.weight.dtype
    for j, blk in enumerate(blocks):
        if (blk.Hp, blk.Wp) != tuple(blk.input_resolution):
            raise ValueError(f"block {j} pads {blk.input_resolution} to "
                             f"{(blk.Hp, blk.Wp)}: the op takes unpadded "
                             f"blocks only")
        if blk.window != window:
            raise ValueError(f"block {j} has window {blk.window}, the stack "
                             f"{window}")
        if (tuple(blk.input_resolution), blk.dim, blk.attn.num_heads) != (
                res, dim, num_heads):
            raise ValueError(f"block {j} is {blk.input_resolution}, dim "
                             f"{blk.dim}, {blk.attn.num_heads} heads; the "
                             f"stack {res}, {dim}, {num_heads}")
        want = window // 2 if use_shift and j % 2 else 0
        if blk.shift != want:
            raise ValueError(f"block {j} has shift {blk.shift} but stack "
                             f"position {j} runs with shift {want}: a stack "
                             f"starts on an unshifted block and alternates")
    N = window * window
    idx = torch.from_numpy(relative_position_index(window).astype(np.int64))
    out = {k: [] for k in STACK_KEYS}
    with torch.no_grad():
        for blk in blocks:
            attn, mlp = blk.attn, blk.mlp
            for key, t in (("ln1_s", blk.norm1.weight), ("ln1_b", blk.norm1.bias),
                           ("ln2_s", blk.norm2.weight), ("ln2_b", blk.norm2.bias)):
                out[key].append(t.detach().float())
            for key, t in (("qkv_w", attn.qkv.weight), ("qkv_b", attn.qkv.bias),
                           ("proj_w", attn.proj.weight),
                           ("proj_b", attn.proj.bias),
                           ("fc1_w", mlp.fc1.weight), ("fc1_b", mlp.fc1.bias),
                           ("fc2_w", mlp.fc2.weight), ("fc2_b", mlp.fc2.bias)):
                out[key].append(t.detach().to(dtype))
            table = attn.relative_position_bias_table.detach().float()
            bias = table[idx.to(table.device).reshape(-1)].reshape(N, N, -1)
            out["rpb"].append(bias.permute(2, 0, 1))
        return {k: torch.stack(v).contiguous() for k, v in out.items()}


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------
def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf by the Abramowitz-Stegun 7.1.26 rational polynomial (|error| <=
    1.5e-7), the TPU kernel's (Mosaic lowers no erf), not torch.erf."""
    sign = torch.sign(x)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               acc: torch.dtype) -> torch.Tensor:
    m = x.to(acc)
    mu = m.mean(-1, keepdim=True)
    var = ((m - mu) ** 2).mean(-1, keepdim=True)
    return (m - mu) * torch.rsqrt(var + 1e-5) * scale.to(acc) + bias.to(acc)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            acc: torch.dtype) -> torch.Tensor:
    """x . w^T + b in `acc` (w in nn.Linear's (out, in) layout)."""
    return torch.matmul(x.to(acc), w.to(acc).t()) + b.to(acc)


def _attention_reference(qkv: torch.Tensor, rpb: torch.Tensor,
                         mask: Optional[torch.Tensor], num_heads: int
                         ) -> torch.Tensor:
    """The attention of one block of the plain version: qkv (B, nW, N, 3C)
    in the activations' dtype, rpb (h, N, N) and mask (nW, N, N) or None
    -> the context (B, nW, N, C) in that dtype.  The logits are the fp32
    q.k^T scaled by hd^-1/2 after the product, plus rpb, plus the mask;
    fp32 softmax; the probabilities and the context cast."""
    B, nW, N, C3 = qkv.shape
    C, dt = C3 // 3, qkv.dtype
    acc = torch.promote_types(dt, torch.float32)
    hd = C // num_heads
    q, k, v = (t.reshape(B, nW, N, num_heads, hd).transpose(2, 3).to(acc)
               for t in qkv.split(C, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    logits = logits + rpb.to(acc)
    if mask is not None:
        logits = logits + mask.to(acc)[:, None]
    probs = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.matmul(probs.to(acc), v).to(dt)
    return ctx.transpose(2, 3).reshape(B, nW, N, C)


def fused_swin_blocks_reference(x: torch.Tensor, sp: Dict[str, torch.Tensor],
                                mask: torch.Tensor, window: int,
                                num_heads: int, use_shift: bool = True
                                ) -> torch.Tensor:
    """Plain version of K3, at the TPU kernel's rounding points (not the
    per-block path's): LayerNorm in fp32 (eps 1e-5) cast to x's dtype;
    every product and its bias in fp32; qkv, the probabilities, the context
    and the projection cast to x's dtype; the logits the fp32 q.k^T scaled
    by hd^-1/2 after the product, plus the fp32 bias and, on shifted
    blocks, the mask; fp32 softmax; the GELU with `_erf`; both residual
    sums in fp32, cast.  Odd blocks roll by -window/2 before and +window/2
    after when `use_shift`.  (float64 inputs stay float64 throughout.)"""
    B, H, W, C = x.shape
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    h = num_heads
    s = window // 2
    act = x
    with torch.autocast(x.device.type, enabled=False):
        for j in range(sp["qkv_w"].shape[0]):
            p = {k: v[j] for k, v in sp.items()}
            shifted = use_shift and j % 2 == 1
            a = torch.roll(act, (-s, -s), (1, 2)) if shifted else act
            xw = window_partition(a, window)                  # (B, nW, N, C)
            h1 = _layernorm(xw, p["ln1_s"], p["ln1_b"], acc).to(dt)
            qkv = _linear(h1, p["qkv_w"], p["qkv_b"], acc).to(dt)
            ctx = _attention_reference(qkv, p["rpb"],
                                       mask if shifted else None, h)
            proj = _linear(ctx, p["proj_w"], p["proj_b"], acc).to(dt)
            a = (a.to(acc) + window_reverse(proj, window, H, W).to(acc)
                 ).to(dt)
            h2 = _layernorm(a, p["ln2_s"], p["ln2_b"], acc).to(dt)
            hm = _linear(h2, p["fc1_w"], p["fc1_b"], acc)
            hm = (0.5 * hm * (1.0 + _erf(hm * 2.0 ** -0.5))).to(dt)
            a = (a.to(acc) + _linear(hm, p["fc2_w"], p["fc2_b"], acc)).to(dt)
            act = torch.roll(a, (s, s), (1, 2)) if shifted else a
    return act


# --------------------------------------------------------------------------
# The kernel (K3)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """K3's library, built on first use, with its C signatures."""
    from fiber_torch.kernels import _build
    lib = _build.load("swin_stage")
    lib.fiber_fused_swin_blocks.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
           ctypes.POINTER(ctypes.c_int)])
    lib.fiber_fused_swin_blocks.restype = ctypes.c_int
    lib.fiber_fused_swin_blocks_smem_bytes.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fiber_fused_swin_blocks_smem_bytes.restype = ctypes.c_longlong
    lib.fiber_fused_swin_blocks_attrs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.fiber_fused_swin_blocks_attrs.restype = ctypes.c_int
    return lib


def cuda_core_attrs(N: int, hd: int, dtype: torch.dtype) -> Dict[str, int]:
    """What the card reports for the CUDA-core K3 instance that a window
    of N tokens at head dim hd runs (8 key chunks a lane up to N = 256,
    11 beyond): registers a thread, local (spilled) bytes a thread, and
    resident blocks an SM at its shared memory, which set the cooperative
    grid.  Needs the card."""
    out = (ctypes.c_int * 3)()
    err = _lib().fiber_fused_swin_blocks_attrs(N, hd, _DTYPE_CODES[dtype], out)
    if err != 0:
        raise RuntimeError(f"fused Swin blocks (CUDA cores): N={N}, hd={hd}, "
                           f"{dtype}: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


@functools.lru_cache(maxsize=None)
def _tc_lib() -> ctypes.CDLL:
    """The tensor-core K3's library, built on first use, with its C
    signatures."""
    from fiber_torch.kernels import _build
    lib = _build.load("swin_stage_tc")
    lib.fiber_fused_swin_blocks_tc.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fiber_fused_swin_blocks_tc.restype = ctypes.c_int
    for what, restype in (("smem_bytes", ctypes.c_longlong),
                          ("blocks_per_sm", ctypes.c_int)):
        f = getattr(lib, f"fiber_fused_swin_blocks_tc_{what}")
        f.argtypes = [ctypes.c_int, ctypes.c_int]
        f.restype = restype
    return lib


@functools.lru_cache(maxsize=None)
def _tc_long_lib() -> ctypes.CDLL:
    """The long-window tensor-core K3's library, built on first use, with
    its C signatures."""
    from fiber_torch.kernels import _build
    lib = _build.load("swin_stage_tc_long")
    lib.fiber_fused_swin_blocks_tc_long.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.fiber_fused_swin_blocks_tc_long.restype = ctypes.c_int
    for what, restype in (("smem_bytes", ctypes.c_longlong),
                          ("blocks_per_sm", ctypes.c_int)):
        f = getattr(lib, f"fiber_fused_swin_blocks_tc_long_{what}")
        f.argtypes = [ctypes.c_int] * 4
        f.restype = restype
    return lib


@functools.lru_cache(maxsize=None)
def _tc_grid(N: int, hd: int, device: int, rows: int = 0, parts: int = 0
             ) -> int:
    """The tensor-core K3's grid for one shape on one card: every block
    resident at once (blocks per SM x SMs); with `rows` the long-window
    kernel's, its attention items R = rows query rows on `parts` warps a
    slab.  Raises where none fits."""
    if rows:
        lib, fn = _tc_long_lib(), "fiber_fused_swin_blocks_tc_long"
        shape, what = (N, hd, rows, parts), "tensor cores, long windows"
    else:
        lib, fn = _tc_lib(), "fiber_fused_swin_blocks_tc"
        shape, what = (N, hd), "tensor cores"
    _check_smem(getattr(lib, f"{fn}_smem_bytes")(*shape), N, hd,
                torch.bfloat16, f"fused Swin blocks ({what})")
    per_sm = getattr(lib, f"{fn}_blocks_per_sm")(*shape)
    if per_sm < 1:
        raise RuntimeError(f"fused Swin blocks ({what}): no block of "
                           f"N={N}, hd={hd} (rows {rows}, parts {parts}) "
                           f"fits an SM ({per_sm})")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def _k3_route(dtype: torch.dtype, N: int, hd: int) -> str:
    """K3's route for one dtype and shape: for bf16 with hd in {8, 16, 32,
    64} "tc" (tensor cores, `swin_stage_tc.cu`) with N <= 144 and
    "tc_long" (tensor cores, `swin_stage_tc_long.cu`) with 144 < N <= 352,
    the shapes their attention routines take; "cuda_core"
    (`swin_stage.cu`) for fp32 (mma.sync has no fp32 path, and the
    card-vs-host checks run fp32 without TF32) and for bf16 at hd = 128."""
    if dtype == torch.bfloat16 and hd in _TC_HEAD_DIMS:
        if N <= _TC_MAX_N:
            return "tc"
        if N <= _LONG_MAX_N:
            return "tc_long"
    return "cuda_core"


# the tensor-core kernel's GEMM tiles (BM, BN), largest first; a product's
# tile goes to the kernel as its index here (kTiles in swin_stage_tc.cu),
# with the kernel's layout of its 8 product warps (rows x columns of warps)
_K3_TILES = ((128, 128), (128, 64), (64, 64))
_K3_WARPS = {(128, 128): (2, 4), (128, 64): (4, 2), (64, 64): (2, 4)}
_K3_PRODUCTS = ("qkv", "proj", "fc1", "fc2")
# the GEMM pipeline's shared memory (kGemmSmem in swin_stage_tc.cuh), and
# the long-window kernel's block (kLongWarps in swin_stage_tc_long.cu): the
# GEMMs on 8 of its warps, the attention on R / 16 x parts of them
_K3_GEMM_SMEM = 83968
_K3_LONG_WARPS = 12


def _k3_tile_bytes(tile: Tuple[int, int]) -> int:
    """Shared-memory bytes one k16 step of a tile moves: each of the 8
    warps' ldmatrix reads (one 512-byte x4 per 16 rows of A and per 16
    columns of W) and the cp.async writes of the tile's A and W slices.
    The kernel's products are bound by that traffic rather than by the
    tensor cores (a warp tile of 64 x 32 reads 192 bytes per mma)."""
    (BM, BN), (WM, WN) = tile, _K3_WARPS[tile]
    reads = 8 * (BM // WM // 16 + BN // WN // 16) * 512
    return reads + (BM + BN) * 16 * 2


def _k3_tile(M: int, n_out: int, grid: int) -> Tuple[int, int]:
    """The tile of one (M, n_out) product on a grid of `grid` blocks: the
    least waves x tile time, the largest tile on a tie.

    Block t of the grid runs tiles t, t + grid, ..., so the product takes
    ceil(tiles / grid) waves; a tile's time is its shared-memory traffic
    (`_k3_tile_bytes`: 128 x 128 moves 2x, 128 x 64 1.375x what 64 x 64
    does for 4x and 2x its outputs).  At FIBER-Base stage 3 / B = 4 on 132
    blocks (M = 2304, C = 512) every product takes 128 x 128, proj and fc2
    in one wave of 72 tiles rather than three of 288 tiles of 64 x 64;
    `chip_smoke.py`'s `k3_tiles` phase times the plan against each tile
    forced on every product."""
    cost = {t: -(-(-(-M // t[0]) * -(-n_out // t[1])) // grid)
            * _k3_tile_bytes(t) for t in _K3_TILES}
    return min(_K3_TILES, key=lambda t: cost[t])


def _k3_long_smem_bytes(N: int, hd: int, R: int, parts: int) -> int:
    """Shared memory of one block of the long-window tensor-core K3: the
    larger of its attention's (`FwdLongLayout`, K1's long-window layout)
    and the GEMM pipeline's."""
    return max(_fwd_long_smem_bytes(N, hd, R, parts), _K3_GEMM_SMEM)


def _k3_long_rows(N: int, hd: int) -> Tuple[int, int]:
    """(R, parts) of the long-window K3's attention items: R query rows of
    one (window, head) on `parts` warps a 16-row slab.  Its persistent
    grid holds one block an SM, so R is the least `_long_cost` at one block
    an SM among those whose block fits (the largest among equals), and
    parts the most, up to K1's 3, whose R / 16 x parts warps fit the
    kernel's block and whose shared memory fits (at N = 324, hd = 32: R =
    64 on 3 parts, K1's plan).  Raises where no R fits."""
    fits = [R for R in range(16, 16 * min(_LONG_MAX_WARPS, _up16(N) // 16)
                             + 1, 16)
            if _k3_long_smem_bytes(N, hd, R, 1) <= _MAX_SMEM]
    if not fits:
        raise ValueError(f"fused Swin blocks (tensor cores, long windows): "
                         f"no block of N={N}, hd={hd} fits {_MAX_SMEM} bytes "
                         f"of shared memory")
    R = min(fits, key=lambda R: (_long_cost(N, R, 1), -R))
    parts = max(p for p in range(1, min(_LONG_MAX_PARTS, _up16(N) // 16) + 1)
                if R // 16 * p <= _K3_LONG_WARPS
                and _k3_long_smem_bytes(N, hd, R, p) <= _MAX_SMEM)
    return R, parts


def _k3_plan(B: int, H: int, W: int, C: int, hidden: int, window: int,
             heads: int, grid: int) -> Dict[str, object]:
    """What the tensor-core K3 runs on a grid of `grid` blocks: the tile
    (BM, BN) of each product and the batch splits of its attention items,
    `_bwd_splits` on that grid as for K1.  Up to N = 144 ("tc") an item is
    (window, head, split); beyond it ("tc_long") (row block, window, head,
    split), with the rows a block ("rows") and warps a slab ("parts") of
    `_k3_long_rows`."""
    M = B * H * W
    N = window * window
    nW = (H // window) * (W // window)
    n_out = {"qkv": 3 * C, "proj": C, "fc1": hidden, "fc2": C}
    plan: Dict[str, object] = {p: _k3_tile(M, n_out[p], max(1, grid))
                               for p in _K3_PRODUCTS}
    if N <= _TC_MAX_N:
        plan["splits"] = _bwd_splits(B, nW, heads, max(1, grid), 1)
        return plan
    R, parts = _k3_long_rows(N, C // heads)
    plan.update(rows=R, parts=parts,
                splits=_bwd_splits(B, nW * -(-N // R), heads, max(1, grid), 1))
    return plan


def _check_stack(x: torch.Tensor, sp: Dict[str, torch.Tensor]) -> int:
    """Shapes, dtypes, devices and layout of the stacked parameters for x;
    returns the MLP width."""
    if set(sp) != set(STACK_KEYS):
        raise ValueError(f"stacked parameters must have the keys "
                         f"{STACK_KEYS}, got {sorted(sp)}")
    n, C = sp["qkv_w"].shape[0], x.shape[-1]
    hidden = sp["fc1_w"].shape[1]
    N = sp["rpb"].shape[-1]
    h = sp["rpb"].shape[1]
    want = {"ln1_s": (n, C), "ln1_b": (n, C), "ln2_s": (n, C),
            "ln2_b": (n, C), "qkv_w": (n, 3 * C, C), "qkv_b": (n, 3 * C),
            "proj_w": (n, C, C), "proj_b": (n, C), "fc1_w": (n, hidden, C),
            "fc1_b": (n, hidden), "fc2_w": (n, C, hidden), "fc2_b": (n, C),
            "rpb": (n, h, N, N)}
    for k, shape in want.items():
        t = sp[k]
        dtype = torch.float32 if k in FP32_KEYS else x.dtype
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{k} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous on {x.device}")
    return hidden


def fused_swin_blocks_cuda(x: torch.Tensor, sp: Dict[str, torch.Tensor],
                           mask: torch.Tensor, window: int, num_heads: int,
                           use_shift: bool = True) -> torch.Tensor:
    """Launch K3 on the route `_k3_route` gives: the whole stack in one
    cooperative launch, one block per resident slot of the card.  Raises on
    anything the kernel does not take."""
    if not x.is_cuda:
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32 or "
                        f"bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, H, W, C), got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    if C % 32 or C % num_heads:
        raise ValueError(f"C={C} must be a multiple of 32 and of "
                         f"num_heads={num_heads}")
    if window < 1 or H % window or W % window:
        raise ValueError(f"{H}x{W} is not a whole number of {window}-windows")
    N = window * window
    hd = C // num_heads
    _check_head_dims(N, hd)
    hidden = _check_stack(x, sp)
    if hidden % 32:
        raise ValueError(f"MLP width {hidden} must be a multiple of 32")
    if tuple(sp["rpb"].shape[1:]) != (num_heads, N, N):
        raise ValueError(f"rpb must be (n, {num_heads}, {N}, {N}), got "
                         f"{tuple(sp['rpb'].shape)}")
    nW = (H // window) * (W // window)
    if mask.dtype != torch.float32 or mask.device != x.device:
        raise TypeError(f"mask must be float32 on {x.device}")
    if use_shift and (tuple(mask.shape) != (nW, N, N)
                      or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous {(nW, N, N)}, got "
                         f"{tuple(mask.shape)}")
    route = _k3_route(x.dtype, N, hd)
    if route in ("tc", "tc_long"):
        if any(t.data_ptr() % 16 for t in (x, mask, *sp.values())):
            raise ValueError("the tensor-core K3 copies 16-byte chunks: x, "
                             "the mask and every stacked parameter must "
                             "start on a 16-byte boundary")
        grid = _tc_grid(N, hd, x.device.index or 0,
                        *(_k3_long_rows(N, hd) if route == "tc_long" else ()))
    else:
        lib = _lib()
        code = _DTYPE_CODES[x.dtype]
        _check_smem(lib.fiber_fused_swin_blocks_smem_bytes(N, hd, code), N,
                    hd, x.dtype, "fused Swin blocks")
    out = torch.empty_like(x)
    if B == 0:
        return out
    M = B * H * W
    qkv = torch.empty((M, 3 * C), dtype=x.dtype, device=x.device)
    ctx = torch.empty((M, C), dtype=x.dtype, device=x.device)
    hid = torch.empty((M, hidden), dtype=x.dtype, device=x.device)
    pointers = (x.data_ptr(), out.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
                hid.data_ptr(), *(sp[k].data_ptr() for k in STACK_KEYS),
                mask.data_ptr())
    shape = (sp["qkv_w"].shape[0], B, H, W, C, hidden, window, num_heads,
             int(use_shift), hd ** -0.5)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route in ("tc", "tc_long"):
            plan = _k3_plan(B, H, W, C, hidden, window, num_heads, grid)
            tiles = [_K3_TILES.index(plan[p]) for p in _K3_PRODUCTS]
            if route == "tc":
                err = _tc_lib().fiber_fused_swin_blocks_tc(
                    *pointers, *shape, grid, plan["splits"], *tiles, stream)
            else:
                err = _tc_long_lib().fiber_fused_swin_blocks_tc_long(
                    *pointers, *shape, grid, plan["splits"], plan["rows"],
                    plan["parts"], *tiles, stream)
        else:
            launched = ctypes.c_int(0)
            err = lib.fiber_fused_swin_blocks(*pointers, *shape, code, stream,
                                              ctypes.byref(launched))
            grid = launched.value
    if err != 0:
        raise RuntimeError(f"fused Swin blocks kernel launch failed "
                           f"({route}): CUDA error {err}")
    fused_swin_blocks.launches += 1
    fused_swin_blocks.route_launches[route] += 1
    fused_swin_blocks.last_grid = grid
    return out


def fused_swin_blocks(x: torch.Tensor, sp: Dict[str, torch.Tensor],
                      mask: torch.Tensor, window: int, num_heads: int,
                      use_shift: bool = True) -> torch.Tensor:
    """Run the stacked blocks `sp` over x (B, H, W, C), H and W multiples
    of `window`: the plain version on a CPU tensor, K3 on a CUDA one.
    `mask` is the (nW, N, N) fp32 shift mask (pass zeros when `use_shift`
    is False).  Stack position j is shifted iff j is odd and `use_shift`.

    `fused_swin_blocks.launches` counts K3's launches,
    `fused_swin_blocks.route_launches` the same by route (`_k3_route`), and
    `fused_swin_blocks.last_grid` holds the grid of the last one."""
    if torch.is_grad_enabled() and (
            x.requires_grad or mask.requires_grad
            or any(t.requires_grad for t in sp.values())):
        raise RuntimeError("fused_swin_blocks is inference-only: it takes "
                           "no gradient (run it under torch.no_grad())")
    if not x.is_cuda:
        return fused_swin_blocks_reference(x, sp, mask, window, num_heads,
                                           use_shift)
    return fused_swin_blocks_cuda(x, sp, mask, window, num_heads, use_shift)


fused_swin_blocks.launches = 0
fused_swin_blocks.route_launches = {"tc": 0, "tc_long": 0, "cuda_core": 0}
fused_swin_blocks.last_grid = 0


@dataclasses.dataclass(frozen=True)
class StageStack:
    """Consecutive blocks of one stage as one K3 op: their stacked
    parameters, shift mask, window, heads and shift flag."""
    params: Dict[str, torch.Tensor]
    mask: torch.Tensor
    window: int
    num_heads: int
    use_shift: bool

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return fused_swin_blocks(x, self.params, self.mask, self.window,
                                 self.num_heads, self.use_shift)


def stack_stage(blocks: Sequence[SwinBlock],
                dtype: Optional[torch.dtype] = None) -> StageStack:
    """`stack_block_params` over consecutive blocks of one stage, the
    window, heads and shift taken from the blocks: the stack shifts iff one
    of them is shifted (a stage's odd blocks; none at a one-window stage),
    with that block's mask, else a zeros (1, N, N) mask."""
    blocks = list(blocks)
    first = blocks[0]
    window, h = first.window, first.attn.num_heads
    use_shift = any(b.shift > 0 for b in blocks)
    params = stack_block_params(blocks, window, h, use_shift, dtype)
    N = window * window
    if use_shift:
        mask = next(b.attn_mask for b in blocks if b.shift > 0)
        mask = mask.float().contiguous()
    else:
        mask = torch.zeros((1, N, N), device=params["rpb"].device)
    return StageStack(params, mask, window, h, use_shift)


def stack_swin(swin: SwinTransformer, n_blocks: Optional[Sequence[int]] = None,
               dtype: Optional[torch.dtype] = None) -> List[StageStack]:
    """One `stack_stage` per stage of `swin`, over the first n_blocks[s]
    blocks of stage s (default: every block of every stage); the list ends
    at the last stage that `n_blocks` names."""
    if n_blocks is None:
        n_blocks = [len(stage.blocks) for stage in swin.layers]
    return [stack_stage(stage.blocks[:n], dtype)
            for stage, n in zip(swin.layers, n_blocks)]


def run_stacks(swin: SwinTransformer, stacks: Sequence[StageStack],
               img: torch.Tensor) -> torch.Tensor:
    """`swin`'s patch embedding, then stacks[s] for stage s with that
    stage's downsample between two stacks.  With a stack for each of
    `swin`'s stages, its final norm follows and the result is (B, L, C), as
    `swin(img)`; with fewer, the tokens (B, H, W, C) after the last stack
    (stages 1-2 and stage 3's unfused blocks give the rerank trunk of
    `FiberCoarse.encode_image_trunk`)."""
    x = swin.embed(img)
    for s, stack in enumerate(stacks):
        x = stack(x)
        if s < len(stacks) - 1:
            x = swin.layers[s].downsample(x)
    if len(stacks) < len(swin.layers):
        return x
    B, H, W, C = x.shape
    return swin.norm(x.reshape(B, H * W, C))
