"""Window-attention backward (kernel K2's op): the port's plain backward
against the JAX package's backward kernel (Pallas, interpret mode) and
against `jax.grad` of its reference, and the op's autograd on the CPU.
K2 itself is held against the plain backward on a CUDA device in
tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.ops import window_attention as jwa
from fiber_torch.ops import window_attention as twa

torch.set_num_threads(1)

# (h, hd): one JAX head group (G = 128 / hd covers all heads) and several
# (hd = 64 -> G = 2 of h = 4 heads, ng = 2)
HEADS = [(2, 8), (4, 64)]
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, nW, N, h, hd, with_mask, seed):
    """qkv, bias (nW, h, N, N) and dout, fp32 numpy; the bias is one RPB
    shared by all windows plus, with a mask, a shift-style -100 mask."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, nW, N, 3 * h * hd)).astype(np.float32)
    b = rng.standard_normal((h, N, N)).astype(np.float32) * 0.1
    bias = np.broadcast_to(b, (nW, h, N, N)).copy()
    if with_mask:
        bias = bias + np.where(rng.random((nW, 1, N, N)) < 0.3, -100.0, 0.0
                               ).astype(np.float32)
    dout = rng.standard_normal((B, nW, N, h * hd)).astype(np.float32)
    return qkv, bias, dout


def _port_bwd(qkv, bias, dout, h):
    dqkv, dbias = twa.window_attention_bwd_reference(
        *(torch.from_numpy(a) for a in (qkv, bias, dout)), h)
    return dqkv.numpy(), dbias.numpy()


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("h,hd", HEADS)
@pytest.mark.parametrize("N", [16, 49])
def test_plain_bwd_matches_pallas_bwd_interpret(N, h, hd, with_mask):
    qkv, bias, dout = _inputs(3, 2, N, h, hd, with_mask, seed=N + hd)
    ref = jwa.window_attention_packed_pallas_bwd(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(dout), h,
        interpret=True)
    for got, want in zip(_port_bwd(qkv, bias, dout, h), ref):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("h,hd", HEADS)
@pytest.mark.parametrize("N", [16, 49])
def test_plain_bwd_matches_jax_grad_of_reference(N, h, hd, with_mask):
    qkv, bias, dout = _inputs(2, 3, N, h, hd, with_mask, seed=7 * N + h)

    def loss(q, b):
        out = jwa.window_attention_windows_reference(q, b, h)
        return jnp.sum(out * jnp.asarray(dout))

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    for got, want in zip(_port_bwd(qkv, bias, dout, h), ref):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_broadcast_bias_gradient_reaches_its_source():
    """An unshifted block passes its (1, h, N, N) RPB broadcast over the
    windows; the gradient reaching that source is the per-window dbias
    summed, as JAX's broadcast_to gives it (the fused op under jax.grad,
    interpret mode)."""
    B, nW, N, h, hd = 2, 4, 16, 4, 64
    qkv, bias, dout = _inputs(B, nW, N, h, hd, False, seed=3)
    src = bias[:1]

    def loss(q, b):
        out = jwa.fused_window_attention_windows(
            q, jnp.broadcast_to(b, (nW, h, N, N)), h, interpret=True)
        return jnp.sum(out * jnp.asarray(dout))

    jq, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(src))
    tq = torch.from_numpy(qkv).requires_grad_(True)
    tsrc = torch.from_numpy(src.copy()).requires_grad_(True)
    out = twa.window_attention(tq, tsrc.expand(nW, h, N, N), h)
    out.backward(torch.from_numpy(dout))
    assert tsrc.grad.shape == (1, h, N, N)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tsrc.grad.numpy(), np.asarray(jb), **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_cpu_autograd_equals_plain_bwd(with_mask):
    """On the CPU the op's gradient is autograd of the plain forward; it
    equals the plain backward (which the card's K2 is held against)."""
    qkv, bias, dout = _inputs(2, 3, 49, 4, 64, with_mask, seed=11)
    tq = torch.from_numpy(qkv).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    before = (twa.window_attention.launches, twa.window_attention_bwd.launches)
    twa.window_attention(tq, tb, 4).backward(torch.from_numpy(dout))
    assert (twa.window_attention.launches,
            twa.window_attention_bwd.launches) == before
    got = twa.window_attention_bwd(*(torch.from_numpy(a)
                                     for a in (qkv, bias, dout)), 4)
    torch.testing.assert_close(tq.grad, got[0], **TOL)
    torch.testing.assert_close(tb.grad, got[1], **TOL)


def test_plain_forward_gradcheck_float64():
    rng = np.random.default_rng(5)
    B, nW, N, h, hd = 2, 2, 5, 2, 4
    qkv = torch.from_numpy(rng.standard_normal((B, nW, N, 3 * h * hd))
                           ).requires_grad_(True)
    bias = torch.from_numpy(rng.standard_normal((nW, h, N, N)) * 0.1
                            ).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q, b: twa.window_attention_reference(q, b, h), (qkv, bias))


def test_bwd_kernel_wrapper_rejects_host_tensors():
    qkv, bias, dout = (torch.from_numpy(a)
                       for a in _inputs(1, 1, 4, 2, 8, False, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        twa.window_attention_bwd_cuda(qkv, bias, dout, 2)


# K2's batch split: FIBER-Base 384^2 stages (nW, h), odd grids, and the
# resident blocks a card may give (132 SMs, 1 or 2 blocks each; a small card)
SPLIT_GRIDS = [(64, 4), (16, 8), (4, 16), (1, 32), (3, 3), (1, 1), (7, 5)]
SPLIT_CARDS = [(132, 1), (132, 2), (16, 3)]


def _waves_x_elements(S, B, blocks, slots):
    """Waves of the (blocks, S) grid times the batch elements a block runs."""
    return -(-blocks * S // slots) * -(-B // S)


@pytest.mark.parametrize("sms,per_sm", SPLIT_CARDS)
@pytest.mark.parametrize("nW,h", SPLIT_GRIDS)
@pytest.mark.parametrize("B", [1, 2, 5, 8, 24])
def test_bwd_splits(B, nW, h, sms, per_sm):
    S = twa._bwd_splits(B, nW, h, sms, per_sm)
    assert 1 <= S <= B
    if B == 1:
        assert S == 1
    # no more waves x elements (within 1/8) than the fewest splits that
    # fill every slot the batch allows, nor than any other split
    slots = sms * per_sm
    fill = min(B, -(-slots // (nW * h)))
    cost = [_waves_x_elements(s, B, nW * h, slots) for s in range(1, B + 1)]
    assert 8 * cost[S - 1] <= 9 * cost[fill - 1]
    assert 8 * cost[S - 1] <= 9 * min(cost)
    assert twa._bwd_splits(B, nW, h, sms, per_sm) == S


def test_bwd_splits_at_the_training_shapes():
    """B = 24 on 132 SMs with one resident block, the splits K2 ran
    fastest at in both dtypes on the H100: stage 1's 256 blocks and
    stage 2's 128 unsplit, stages 3 and 4 split into 2 and 4 for 128
    blocks each (one wave; 256 blocks would be two waves of half the
    elements)."""
    assert [twa._bwd_splits(24, nW, h, 132, 1)
            for nW, h in SPLIT_GRIDS[:4]] == [1, 1, 2, 4]


# FIBER's windows at 576^2 (18 x 18, N = 324) and a window past the
# whole-tile kernels (N = 150): the plain backward that K2's long-window
# kernels are held against, against the JAX package's backward kernel and
# its reference's grad
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("N", [150, 324])
def test_plain_bwd_matches_pallas_bwd_interpret_long_windows(N, with_mask):
    qkv, bias, dout = _inputs(1, 1, N, 1, 8, with_mask, seed=N)
    ref = jwa.window_attention_packed_pallas_bwd(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(dout), 1,
        interpret=True)
    for got, want in zip(_port_bwd(qkv, bias, dout, 1), ref):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("N", [150, 324])
def test_plain_bwd_matches_jax_grad_of_reference_long_windows(N, with_mask):
    qkv, bias, dout = _inputs(1, 1, N, 1, 8, with_mask, seed=3 * N)

    def loss(q, b):
        out = jwa.window_attention_windows_reference(q, b, 1)
        return jnp.sum(out * jnp.asarray(dout))

    ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    for got, want in zip(_port_bwd(qkv, bias, dout, 1), ref):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
