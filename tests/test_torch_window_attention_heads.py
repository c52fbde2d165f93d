"""Per-head window attention (kernel K4's op): the port's plain version and
`window_attention_per_head_call` against the JAX package's `_kernel_call`
in interpret mode, and against the packed plain version, on the CPU.  The
kernel itself is held against the plain version on a CUDA device in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.ops import window_attention as jwa
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

# (B, nW, N, h, hd): a 4-window stage, one window of many heads, N = 49, and
# one of FIBER's 18 x 18 windows at 576^2 (N = 324)
SHAPES = [(2, 4, 16, 2, 8), (2, 1, 16, 4, 32), (1, 3, 49, 2, 64),
          (1, 1, 324, 2, 16)]


def _inputs(B, nW, N, h, hd, seed, with_mask=True):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, nW, N, 3 * h * hd)).astype(np.float32)
    bias = np.broadcast_to(rng.standard_normal((h, N, N)).astype(np.float32)
                           * 0.1, (nW, h, N, N)).copy()
    if with_mask:
        bias += np.where(rng.random((nW, 1, N, N)) < 0.3, -100.0, 0.0
                         ).astype(np.float32)
    return qkv, bias


def _jax_kernel_call(qkv, bias, h):
    return np.asarray(jwa._kernel_call(jnp.asarray(qkv), jnp.asarray(bias), h,
                                       windows_per_program=0, interpret=True))


@pytest.mark.parametrize("shape", SHAPES)
def test_per_head_call_matches_jax_kernel_call(shape):
    B, nW, N, h, hd = shape
    qkv, bias = _inputs(B, nW, N, h, hd, seed=sum(shape))
    ref = _jax_kernel_call(qkv, bias, h)
    out = twa.window_attention_per_head_call(torch.from_numpy(qkv),
                                             torch.from_numpy(bias), h)
    assert out.shape == (B, nW, N, h * hd)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_heads_plain_matches_jax_on_split_heads(shape):
    """The per-head plain version on the operands `_kernel_call` splits."""
    B, nW, N, h, hd = shape
    qkv, bias = _inputs(B, nW, N, h, hd, seed=2 * sum(shape))
    q, k, v = twa.split_heads_qkv(torch.from_numpy(qkv), h)
    assert all(t.is_contiguous() and t.shape == (B, nW, h, N, hd)
               for t in (q, k, v))
    out = twa.window_attention_heads_reference(q, k, v,
                                               torch.from_numpy(bias))
    ref = _jax_kernel_call(qkv, bias, h).reshape(B, nW, N, h, hd)
    np.testing.assert_allclose(out.numpy(), ref.transpose(0, 1, 3, 2, 4),
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_reference_equals_packed_reference(dtype):
    B, nW, N, h, hd = 2, 4, 16, 4, 16
    qkv, bias = _inputs(B, nW, N, h, hd, seed=7)
    qkv, bias = torch.from_numpy(qkv).to(dtype), torch.from_numpy(bias)
    packed = twa.window_attention_reference(qkv, bias, h)
    heads = twa.window_attention_heads_reference(
        *twa.split_heads_qkv(qkv, h), bias)
    torch.testing.assert_close(heads.transpose(2, 3).reshape(B, nW, N, -1),
                               packed, rtol=0, atol=1e-6)


def test_cpu_tensor_takes_plain_path_with_broadcast_bias():
    qkv, bias = _inputs(2, 4, 16, 2, 8, seed=3, with_mask=False)
    q, k, v = twa.split_heads_qkv(torch.from_numpy(qkv), 2)
    one = torch.from_numpy(bias[:1])
    before = twa.window_attention_heads.launches
    out = twa.window_attention_heads(q, k, v, one.expand(4, 2, 16, 16))
    assert twa.window_attention_heads.launches == before
    torch.testing.assert_close(out, twa.window_attention_heads_reference(
        q, k, v, one.expand(4, 2, 16, 16).contiguous()), rtol=0, atol=0)


def test_kernel_wrapper_rejects_host_tensors():
    qkv, bias = _inputs(1, 1, 4, 2, 8, seed=5)
    q, k, v = twa.split_heads_qkv(torch.from_numpy(qkv), 2)
    with pytest.raises(ValueError, match="CUDA"):
        twa.window_attention_heads_cuda(q, k, v, torch.from_numpy(bias))
