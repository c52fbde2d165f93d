"""Window attention (kernel K1's op): the port's plain version against the
JAX reference and the interpret-mode Pallas kernel, and the op's dispatch.
The kernel itself is held against the plain version on a CUDA device in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.ops import window_attention as jwa
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

# (h, hd): one head group (G = 128 / hd covers all heads) and several
# (hd = 64 -> G = 2 of h = 4 heads)
HEADS = [(2, 8), (4, 64)]


def _inputs(B, nW, N, h, hd, with_mask, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, nW, N, 3 * h * hd)).astype(np.float32)
    b = rng.standard_normal((h, N, N)).astype(np.float32) * 0.1
    bias = np.broadcast_to(b, (nW, h, N, N)).copy()
    if with_mask:
        bias = bias + np.where(rng.random((nW, 1, N, N)) < 0.3, -100.0, 0.0
                               ).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("h,hd", HEADS)
@pytest.mark.parametrize("N", [4, 16, 49])
def test_plain_matches_jax_reference(N, h, hd, with_mask):
    qkv, bias = _inputs(2, 3, N, h, hd, with_mask, seed=N + h)
    ref = jwa.window_attention_windows_reference(jnp.asarray(qkv),
                                                 jnp.asarray(bias), h)
    out = twa.window_attention_reference(torch.from_numpy(qkv),
                                         torch.from_numpy(bias), h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("h,hd", HEADS)
@pytest.mark.parametrize("N", [4, 16, 49])
def test_plain_matches_pallas_interpret(N, h, hd, with_mask):
    qkv, bias = _inputs(2, 3, N, h, hd, with_mask, seed=10 * N + h)
    ref = jwa.window_attention_packed_pallas(
        jnp.asarray(qkv), jnp.asarray(bias), h, interpret=True)
    out = twa.window_attention_reference(torch.from_numpy(qkv),
                                         torch.from_numpy(bias), h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_cpu_tensor_takes_plain_path():
    qkv, bias = _inputs(2, 4, 16, 2, 8, True, seed=3)
    qkv, bias = torch.from_numpy(qkv), torch.from_numpy(bias)
    before = twa.window_attention.launches
    out = twa.window_attention(qkv, bias, 2)
    assert twa.window_attention.launches == before
    torch.testing.assert_close(out, twa.window_attention_reference(qkv, bias, 2),
                               rtol=0, atol=0)


def test_broadcast_bias_equals_materialised():
    """A bias shared by all windows may come as a stride-0 view."""
    qkv, bias = _inputs(2, 4, 16, 2, 8, False, seed=4)
    qkv, one = torch.from_numpy(qkv), torch.from_numpy(bias[:1])
    out = twa.window_attention(qkv, one.expand(4, 2, 16, 16), 2)
    ref = twa.window_attention(qkv, one.expand(4, 2, 16, 16).contiguous(), 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_kernel_wrapper_rejects_host_tensors():
    qkv, bias = _inputs(1, 1, 4, 2, 8, False, seed=5)
    with pytest.raises(ValueError, match="CUDA"):
        twa.window_attention_cuda(torch.from_numpy(qkv),
                                  torch.from_numpy(bias), 2)
