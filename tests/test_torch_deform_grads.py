"""The gradients of the port's modulated deformable conv
(`fiber_torch/detection/deform_conv.py`) against the JAX package's on the
CPU: the reference for the card's fp32 backward, which `chip_smoke.py`'s
phase `deform_bwd_card_vs_host` holds against the host's fp64 (the
backward's scatter-add of the four corner gathers sums in no fixed order
on the card).  fp32 on both sides; the port in fp64 too, each within its
tolerance of the output's scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.detection.deform_conv import \
    modulated_deform_conv2d as jax_deform
from fiber_torch.detection.deform_conv import modulated_deform_conv2d

torch.set_num_threads(1)


def _inputs(stride: int, seed: int):
    """NHWC inputs as the JAX package takes them, with offsets that put
    samples across and beyond the borders but never on a grid line (where
    the bilinear weights' derivative jumps)."""
    rng = np.random.default_rng(seed)
    B, H, W, Cin, Cout = 2, 9, 11, 6, 5
    Ho, Wo = -(-H // stride), -(-W // stride)
    x = rng.standard_normal((B, H, W, Cin))
    off = rng.standard_normal((B, Ho, Wo, 18)) * 2.5
    off += np.where(np.abs(off - np.round(off)) < 1e-3, 0.01, 0.0)
    mask = rng.uniform(0.05, 0.95, (B, Ho, Wo, 9))
    w = rng.standard_normal((3, 3, Cin, Cout)) / np.sqrt(9 * Cin)
    b = rng.standard_normal(Cout) * 0.1
    g = rng.standard_normal((B, Ho, Wo, Cout))
    return [a.astype(np.float32) for a in (x, off, mask, w, b, g)]


def _jax_grads(x, off, mask, w, b, g, stride):
    fn = jax.vmap(functools.partial(jax_deform, stride=stride),
                  in_axes=(0, 0, 0, None, None))
    loss = lambda *a: jnp.sum(fn(*a) * g)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, off, mask, w, b)))
    return [np.asarray(t, np.float64) for t in grads]


def _port_grads(x, off, mask, w, b, g, stride, dtype):
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    leaves = [to(x.transpose(0, 3, 1, 2)), to(off.transpose(0, 3, 1, 2)),
              to(mask.transpose(0, 3, 1, 2)), to(w.transpose(3, 2, 0, 1)),
              to(b)]
    for t in leaves:
        t.requires_grad_(True)
    out = modulated_deform_conv2d(*leaves, stride=stride)
    (out * to(g.transpose(0, 3, 1, 2))).sum().backward()
    dx, doff, dmask, dw, db = (t.grad.double().numpy() for t in leaves)
    # back to the JAX package's layouts
    return [dx.transpose(0, 2, 3, 1), doff.transpose(0, 2, 3, 1),
            dmask.transpose(0, 2, 3, 1), dw.transpose(2, 3, 1, 0), db]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_grads_match_jax(stride, dtype):
    """d/dx, d/doffset, d/dmask, d/dweight and d/dbias of sum(out * g):
    the port against JAX's fp32 gradients within 1e-5 of each gradient's
    max-abs (the sums run in other orders; fp64 on the port's side leaves
    JAX's fp32 rounding alone)."""
    args = _inputs(stride, seed=10 + stride)
    want = _jax_grads(*args, stride)
    got = _port_grads(*args, stride, dtype)
    for name, a, b in zip(("x", "offset", "mask", "weight", "bias"), got,
                          want):
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
