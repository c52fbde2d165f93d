"""Window attention: the Swin attention core as one op.

`window_attention(qkv, bias, num_heads)` takes the packed projections
(B, nW, N, 3C) and the per-window logit bias (nW, h, N, N) fp32 (relative
position bias plus shift mask, shared over the batch) and returns
(B, nW, N, C) in the input dtype.

On a CPU tensor it runs `window_attention_reference`, the plain PyTorch
version.  On a CUDA tensor it launches the hand-written kernel of
`fiber_torch/csrc/window_attention.cu` or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128)
_MAX_N = 256
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """Plain version: q scaled in the input dtype before the product, fp32
    logits plus the fp32 bias, fp32 softmax, probabilities cast to the
    input dtype, then P.V."""
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    hd = C // h
    scale = hd ** -0.5

    x = qkv.reshape(B, nW, N, 3, h, hd)
    q = x[:, :, :, 0].transpose(2, 3) * scale           # (B, nW, h, N, hd)
    k = x[:, :, :, 1].transpose(2, 3)
    v = x[:, :, :, 2].transpose(2, 3)

    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = attn + bias[None].float()
    attn = torch.softmax(attn, dim=-1).to(qkv.dtype)
    out = torch.matmul(attn, v)
    return out.transpose(2, 3).reshape(B, nW, N, C)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
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


def window_attention_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Launch the CUDA kernel.  Raises on anything it does not take."""
    if not qkv.is_cuda or bias.device != qkv.device:
        raise ValueError(f"qkv and bias must be on one CUDA device, got "
                         f"{qkv.device} and {bias.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype {qkv.dtype} not supported "
                        f"(float32 or bfloat16)")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if qkv.requires_grad or bias.requires_grad:
        raise RuntimeError("window_attention's CUDA kernel is forward only: "
                           "its backward is not ported yet")
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, nW, N, 3C), got {tuple(qkv.shape)}")
    B, nW, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads:
        raise ValueError(f"C={C} not divisible by num_heads={num_heads}")
    hd = C // num_heads
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported ({_HEAD_DIMS})")
    if not 1 <= N <= _MAX_N:
        raise ValueError(f"window of {N} tokens not supported (1..{_MAX_N})")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    h = num_heads
    if tuple(bias.shape) != (nW, h, N, N):
        raise ValueError(f"bias must be {(nW, h, N, N)}, got "
                         f"{tuple(bias.shape)}")
    # the window axis may be broadcast (stride 0); each window is contiguous
    sw = bias.stride(0) if nW > 1 else 0
    if not bias[0].is_contiguous() or sw not in (0, h * N * N):
        raise ValueError(f"bias strides {bias.stride()} not supported")
    lib = _lib()
    code = _DTYPE_CODES[qkv.dtype]
    smem = lib.fiber_window_attention_smem_bytes(N, hd, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"N={N}, hd={hd}, {qkv.dtype} needs {smem} bytes of "
                         f"shared memory, more than a block has")
    out = torch.empty((B, nW, N, C), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fiber_window_attention_fwd(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), B, nW, N, h, hd,
            sw, hd ** -0.5, code, stream)
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: CUDA "
                           f"error {err}")
    window_attention.launches += 1
    return out


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """The op: plain version on a CPU tensor, the kernel on a CUDA one.

    `window_attention.launches` counts the kernel's launches."""
    if qkv.is_cuda:
        return window_attention_cuda(qkv, bias, num_heads)
    return window_attention_reference(qkv, bias, num_heads)


window_attention.launches = 0
