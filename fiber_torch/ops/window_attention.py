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
grid of query-row blocks that `_long_plan` sizes; fp32, and bf16 at
hd = 128, the CUDA-core kernel of `fiber_torch/csrc/window_attention.cu`
(route "cuda_core").  K1 takes N <= 352; its backward (K2), K3 and K4
take N <= 256.  When grad is enabled and an input requires it, K1
runs inside `_WindowAttentionFunction`, which saves only (qkv, bias) and
whose backward launches K2 (`window_attention_bwd`): for bf16 the
tensor-core kernel of `fiber_torch/csrc/window_attention_bwd_tc.cu`, for
fp32 the CUDA-core kernel of `fiber_torch/csrc/window_attention_bwd.cu`.
On the card each kernel launches or raises: there is no fallback to the
plain version.

`window_attention_heads(q, k, v, bias)` is the same forward on per-head
operands (B, nW, h, N, hd), the layout of the JAX package's `_kernel_call`;
on the card it launches K4, by the same route rule without the long
windows (`_heads_route`): `fiber_torch/csrc/window_attention_heads_tc.cu`
or `fiber_torch/csrc/window_attention_heads.cu`.
`window_attention_per_head_call` wraps it as `_kernel_call` does: split the
heads of the packed qkv, attend, merge.  No model path calls K4;
`fiber_torch/tools/profile_tail.py` times it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128)
_MAX_N = 256       # K2, K3 and K4
_K1_MAX_N = 352    # K1: FIBER's 18 x 18 windows at 576^2 (N = 324)
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
_SM_SMEM = 233472   # bytes of shared memory an SM gives its blocks
_BLOCK_SMEM_RESERVED = 1024  # bytes the card keeps per resident block
# the forward's tensor-core kernels: a 16-row slab's logits (N / 2 fp32 a
# thread) in registers, and q, K, V at hd <= 64 beside the bias tile
_TC_MAX_N = 144
_TC_HEAD_DIMS = (8, 16, 32, 64)
# the long-window kernel (N <= _K1_MAX_N): all keys staged, R = 16 x warps
# query rows a block
_LONG_MAX_WARPS = 8


def _fwd_route(dtype: torch.dtype, N: int, hd: int) -> str:
    """K1's route for one dtype and shape: "tc" (tensor cores) for bf16
    with N <= 144 and hd in {8, 16, 32, 64}, "tc_long" (tensor cores, rows
    split over blocks) for bf16 with 144 < N <= 352 and the same head dims,
    "cuda_core" for fp32 (mma.sync has no fp32 path, and the card-vs-host
    checks run fp32 without TF32) and for bf16 beyond those limits."""
    if dtype == torch.bfloat16 and hd in _TC_HEAD_DIMS:
        if N <= _TC_MAX_N:
            return "tc"
        if N <= _K1_MAX_N:
            return "tc_long"
    return "cuda_core"


def _heads_route(dtype: torch.dtype, N: int, hd: int) -> str:
    """K4's route: K1's, except that K4 has no long-window kernel, so bf16
    beyond N = 144 runs on the CUDA cores."""
    return "tc" if _fwd_route(dtype, N, hd) == "tc" else "cuda_core"


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _long_smem_bytes(N: int, hd: int, R: int) -> int:
    """Shared memory of one block of `window_attention_tc_long.cu` (its
    `LongLayout`): R bias rows of NP + 8 fp32, then two buffers of K and V
    (NP rows each) and q (R rows), bf16 rows of max(hd, 16) + 8; NP is N
    padded to 16."""
    NP, ldo = _up16(N), max(hd, 16) + 8
    kv, q = _up16(2 * NP * ldo), _up16(2 * R * ldo)
    return _up16(4 * R * (NP + 8)) + 2 * (2 * kv + q)


def _long_blocks_per_sm(N: int, hd: int, R: int) -> int:
    """Resident blocks per SM of the long-window kernel at R query rows a
    block, from its shared memory (an SM's 233,472 bytes, 1,024 reserved
    per block) and the 64 warps an SM holds; 0 where a block does not fit
    its 232,448 bytes."""
    smem = _long_smem_bytes(N, hd, R)
    if smem > _MAX_SMEM:
        return 0
    return min(_SM_SMEM // (smem + _BLOCK_SMEM_RESERVED), 64 // (R // 16))


def _long_rows(N: int, hd: int) -> int:
    """R, the long-window kernel's query rows a block (16 a warp, up to 8
    warps).  A warp's slab is latency-bound, so a block takes about as long
    as its busiest scheduler (an SM has 4) has warps: of the R that fit,
    the least ceil(N / R) row blocks x ceil(blocks per SM x warps / 4) /
    blocks per SM, and among those the largest R (the fewest stagings of K
    and V).  On an H100 at N = 324, hd = 32 (stage 1, B = 4) R = 64 (4
    warps, 6 row blocks) ran 0.391 ms, R = 80 (5 warps, one scheduler with
    two) 0.403 and R = 48 0.475.  Raises where no R fits."""
    slabs = _up16(N) // 16
    fits = [R for R in range(16, 16 * min(_LONG_MAX_WARPS, slabs) + 1, 16)
            if _long_blocks_per_sm(N, hd, R)]
    if not fits:
        raise ValueError(f"window attention (long windows): no block of "
                         f"N={N}, hd={hd} fits {_MAX_SMEM} bytes of shared "
                         f"memory")

    def cost(R: int) -> Tuple[float, int]:
        warps, per_sm = R // 16, _long_blocks_per_sm(N, hd, R)
        return -(-slabs // warps) * -(-per_sm * warps // 4) / per_sm, -R

    return min(fits, key=cost)


def _long_plan(B: int, nW: int, h: int, N: int, hd: int, sms: int
               ) -> Tuple[int, int, int]:
    """(R, S, blocks per SM) of the long-window kernel's (nW h,
    ceil(N / R), S) grid: `_long_rows`' R query rows a block, and S splits
    of the batch by `_bwd_splits` over the nW h ceil(N / R) blocks."""
    R = _long_rows(N, hd)
    per_sm = _long_blocks_per_sm(N, hd, R)
    return R, _bwd_splits(B, nW * -(-N // R), h, sms, per_sm), per_sm


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


# K2's two routes, by dtype: the library and the prefix of its C functions
_BWD_ROUTES = {torch.float32: ("cuda_core", "window_attention_bwd"),
               torch.bfloat16: ("tc", "window_attention_bwd_tc")}


# The kernels on the (nW h, S) grid, by library: K2's two routes and the
# forward's tensor-core kernels.  Each has a C entry taking its tensors'
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


def _bwd_plan(dtype: torch.dtype, N: int, hd: int, device: int
              ) -> Tuple[str, str, int, int]:
    """(route, library name, SMs, resident blocks per SM) of K2 for one
    shape on one card.  Raises where the shape does not fit a block."""
    route, name = _BWD_ROUTES[dtype]
    return (route, name) + _split_plan(name, dtype, N, hd, device)


def _launch_fwd_tc(name: str, tensors: Tuple[torch.Tensor, ...], B: int,
                   nW: int, N: int, h: int, hd: int, sw: int) -> int:
    """Launch the forward tensor-core kernel of library `name` on `tensors`
    (its operands, the bias and the output, on one device) at
    `_bwd_splits`' batch splits.  It copies 16-byte chunks: raises where a
    tensor does not start on a 16-byte boundary, and where the launch
    fails.  Returns the splits."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} copies 16-byte chunks: the operands, the "
                         f"bias and the output must start on a 16-byte "
                         f"boundary")
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
def _long_lib() -> ctypes.CDLL:
    """The long-window forward kernel's library, built on first use, with
    its C signatures."""
    from fiber_torch.kernels import _build
    lib = _build.load("window_attention_tc_long")
    lib.fiber_window_attention_tc_long_fwd.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p])
    lib.fiber_window_attention_tc_long_fwd.restype = ctypes.c_int
    for what, restype in (("smem_bytes", ctypes.c_longlong),
                          ("blocks_per_sm", ctypes.c_int)):
        f = getattr(lib, f"fiber_window_attention_tc_long_{what}")
        f.argtypes = [ctypes.c_int] * 3
        f.restype = restype
    return lib


def _launch_fwd_tc_long(qkv: torch.Tensor, bias: torch.Tensor,
                        out: torch.Tensor, B: int, nW: int, N: int, h: int,
                        hd: int, sw: int) -> Tuple[int, int]:
    """Launch the long-window kernel at `_long_plan`'s rows and splits.
    It copies 16-byte chunks: raises where a tensor does not start on a
    16-byte boundary, and where the launch fails.  Returns (R, S)."""
    if any(t.data_ptr() % 16 for t in (qkv, bias, out)):
        raise ValueError("window_attention_tc_long copies 16-byte chunks: "
                         "qkv, the bias and the output must start on a "
                         "16-byte boundary")
    dev = qkv.device.index or 0
    R, splits, _ = _long_plan(
        B, nW, h, N, hd,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _long_lib().fiber_window_attention_tc_long_fwd(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, nW, N, h, hd,
            sw, hd ** -0.5, R, splits, stream)
    if err != 0:
        raise RuntimeError(f"window_attention_tc_long kernel launch failed: "
                           f"CUDA error {err}")
    return R, splits


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


def _check_head_dims(N: int, hd: int, max_n: int = _MAX_N) -> None:
    """The head dims the kernels build, and a window of at most `max_n`
    tokens: `_MAX_N` for K2, K3 and K4, `_K1_MAX_N` for K1."""
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported ({_HEAD_DIMS})")
    if not 1 <= N <= max_n:
        raise ValueError(f"window of {N} tokens not supported (1..{max_n})")


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


def _check_inputs(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                  max_n: int = _MAX_N
                  ) -> Tuple[int, int, int, int, int, int]:
    """What K1 (`max_n` = `_K1_MAX_N`) and K2 take; returns (B, nW, N, h,
    hd, bias window stride).  Raises on anything else."""
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
    _check_head_dims(N, hd, max_n)
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
    B, nW, N, h, hd, sw = _check_inputs(qkv, bias, num_heads, _K1_MAX_N)
    route = _fwd_route(qkv.dtype, N, hd)
    if route == "cuda_core":
        lib = _lib()
        code = _DTYPE_CODES[qkv.dtype]
        _check_smem(lib.fiber_window_attention_smem_bytes(N, hd, code), N,
                    hd, qkv.dtype, "window attention")
    out = torch.empty((B, nW, N, h * hd), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    rows = N                       # query rows a block
    if route == "tc":
        splits = _launch_fwd_tc("window_attention_tc", (qkv, bias, out), B,
                                 nW, N, h, hd, sw)
    elif route == "tc_long":
        rows, splits = _launch_fwd_tc_long(qkv, bias, out, B, nW, N, h, hd,
                                           sw)
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
    window_attention.route_launches[route] += 1
    window_attention.last_splits = splits
    window_attention.last_rows = rows
    return out


def window_attention_bwd_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                              dout: torch.Tensor, num_heads: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (K2): (dqkv, dbias (nW, h, N, N) fp32).

    The route is fixed by the dtype: bf16 runs the tensor-core kernel of
    `csrc/window_attention_bwd_tc.cu`, fp32 the CUDA-core kernel of
    `csrc/window_attention_bwd.cu`.  Both split the batch over S blocks
    per (window, head) (`_bwd_splits`) and sum the S dbias partials in a
    fixed order.  Raises on anything the kernel does not take, and where a
    launch fails: there is no fallback."""
    B, nW, N, h, hd, sw = _check_inputs(qkv, bias, num_heads)
    if dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise TypeError(f"dout must be {qkv.dtype} on {qkv.device}, got "
                        f"{dout.dtype} on {dout.device}")
    if tuple(dout.shape) != (B, nW, N, h * hd) or not dout.is_contiguous():
        raise ValueError(f"dout must be contiguous {(B, nW, N, h * hd)}, got "
                         f"{tuple(dout.shape)} strides {dout.stride()}")
    route, name, sms, per_sm = _bwd_plan(qkv.dtype, N, hd,
                                         qkv.device.index or 0)
    if route == "tc" and any(t.data_ptr() % 16 for t in (qkv, bias, dout)):
        raise ValueError("the bf16 backward copies 16-byte chunks: qkv, bias "
                         "and dout must start on a 16-byte boundary")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nW, h, N, N), dtype=torch.float32,
                        device=qkv.device)
    if B == 0:
        return dqkv, dbias.zero_()
    splits = _bwd_splits(B, nW, h, sms, per_sm)
    partials = (torch.empty((splits, nW, h, N, N), dtype=torch.float32,
                            device=qkv.device) if splits > 1 else dbias)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_split_lib(name), _SPLIT_ENTRIES[name][0])(
            qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
            dqkv.data_ptr(), dbias.data_ptr(), partials.data_ptr(), B, nW,
            N, h, hd, sw, hd ** -0.5, splits, stream)
    if err != 0:
        raise RuntimeError(f"window attention backward kernel launch "
                           f"failed ({route}): CUDA error {err}")
    window_attention_bwd.launches += 1
    window_attention_bwd.route_launches[route] += 1
    window_attention_bwd.last_splits = splits
    return dqkv, dbias


def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         dout: torch.Tensor, num_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward op: plain version on a CPU tensor, K2 on a CUDA one.

    `window_attention_bwd.launches` counts K2's launches,
    `window_attention_bwd.route_launches` the same by route ("tc" for
    bf16, "cuda_core" for fp32), and `window_attention_bwd.last_splits`
    holds the batch splits of the last launch."""
    if qkv.is_cuda:
        return window_attention_bwd_cuda(qkv, bias, dout, num_heads)
    return window_attention_bwd_reference(qkv, bias, dout, num_heads)


window_attention_bwd.launches = 0
window_attention_bwd.route_launches = {"tc": 0, "cuda_core": 0}
window_attention_bwd.last_splits = 0


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
    `window_attention.last_rows` its query rows a block (N but on route
    "tc_long")."""
    if not qkv.is_cuda:
        return window_attention_reference(qkv, bias, num_heads)
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        return _WindowAttentionFunction.apply(qkv, bias, num_heads)
    return window_attention_cuda(qkv, bias, num_heads)


window_attention.launches = 0
window_attention.route_launches = {"tc": 0, "tc_long": 0, "cuda_core": 0}
window_attention.last_splits = 0
window_attention.last_rows = 0


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
    if route == "tc":
        splits = _launch_fwd_tc("window_attention_heads_tc",
                                 (q, k, v, bias, out), B, nW, N, h, hd, sw)
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
    window_attention_heads.route_launches[route] += 1
    window_attention_heads.last_splits = splits
    return out


def window_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """The per-head op, forward only: plain version on a CPU tensor, K4 on
    a CUDA one.  `window_attention_heads.launches` counts K4's launches,
    `.route_launches` the same by route and `.last_splits` the batch
    splits of the last launch, as for `window_attention`."""
    if not q.is_cuda:
        return window_attention_heads_reference(q, k, v, bias)
    return window_attention_heads_cuda(q, k, v, bias)


window_attention_heads.launches = 0
window_attention_heads.route_launches = {"tc": 0, "cuda_core": 0}
window_attention_heads.last_splits = 0


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
