"""Shared set-up of the parity tests of the early-fusion head, the Swin-T
trunks, the backbone registry and the module zoo between `fiber_tpu` and
`fiber_torch`.

A JAX module's parameter shapes come from `jax.eval_shape` of its init
(traced, not compiled), its values from a seeded numpy generator
(`random_params`), and its forward from one `jax.jit`.
The port takes the same values through `fiber_torch.utils.convert`.
"""

from __future__ import annotations

from typing import Dict
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fiber_tpu.models import swin_v2 as jswin_v2


def abstract_params(module, *args, **kwargs) -> Dict:
    """The module's parameter tree of `jax.ShapeDtypeStruct`s."""
    init = lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs)
    return _traced(jax.eval_shape, init, *args)["params"]


class _NumpyLinspace:
    """jax.numpy with numpy's `linspace`."""

    def __getattr__(self, name):
        return np.linspace if name == "linspace" else getattr(jnp, name)


def _traced(transform, fn, *args):
    """transform(fn)(*args).  The JAX Swin-v2 trunk's `setup` turns a
    `jnp.linspace` into Python floats, which fails under a trace: then
    again with numpy's `linspace` in that module."""
    try:
        return transform(fn, *args)
    except jax.errors.ConcretizationTypeError:
        with mock.patch.object(jswin_v2, "jnp", _NumpyLinspace()):
            return transform(fn, *args)


def random_params(abstract, seed: int) -> Dict[str, np.ndarray]:
    """Seeded values for every leaf, flattened to "a/b/c" paths: kernels
    normal with std 1/sqrt(fan_in), norm scales and fusion weights 1 +
    N(0, 0.1), frozen-BN variances U(0.5, 1.5), everything else (biases,
    layer scales, position tables, embeddings) N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    flat = flax.traverse_util.flatten_dict(abstract, sep="/")
    for k, s in sorted(flat.items()):
        shape = tuple(s.shape)
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "kernel" and len(shape) >= 2:
            v = rng.normal(0, int(np.prod(shape[:-1])) ** -0.5, shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("scale", "v") or leaf.endswith(("_w1", "_w2")):
            v = 1.0 + rng.normal(0, 0.1, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        out[k] = v.astype(np.float32)
    return out


def unflatten(flat: Dict[str, np.ndarray]):
    return flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def jax_apply(module, flat: Dict[str, np.ndarray], *args, **kwargs):
    """The module's forward on the flat parameters, jitted once."""
    fn = lambda p, *a: module.apply({"params": p}, *a, **kwargs)
    return _traced(lambda f, *a: jax.jit(f)(*a), fn, unflatten(flat), *args)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def assert_close(got, want, atol: float, what: str = "") -> None:
    """|got - want| <= atol * max(1, max |want|)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= atol * scale, f"{what}: {err} > {atol} x {scale}"


def feats_nhwc(B: int, C: int, sizes, seed: int):
    """Seeded NHWC feature maps of the given (H, W) sizes."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, w, C)).astype(np.float32)
            for h, w in sizes]


def text(B: int, T: int, D: int, seed: int):
    """Seeded (B, T, D) text and a mask, the last row padded from T/2."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.int32)
    mask[-1, T // 2:] = 0
    return rng.standard_normal((B, T, D)).astype(np.float32), mask
