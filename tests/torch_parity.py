"""Shared set-up of the parity tests between `fiber_tpu` and `fiber_torch`.

One seed draws the JAX parameters (`FiberCoarse.init_full`); every fusion
gate is then set non-zero and every bias and LayerNorm scale is perturbed,
so that the cross-attention paths and the name mapping are both held.  The
flattened numpy tree goes through `params_from_flax` into the port.
"""

from __future__ import annotations

from typing import Dict, Tuple

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.models.fiber import FiberCoarse as JaxFiberCoarse
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.utils.convert import params_from_flax

LOSSES = ("itm", "mlm", "itc", "vqa", "nlvr2")


def flatten(params) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params, sep="/").items()}


def unflatten(flat: Dict[str, np.ndarray]):
    return flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def perturb(flat: Dict[str, np.ndarray], seed: int) -> Dict[str, np.ndarray]:
    """Fusion gates uniform in [0.3, 0.7]; biases and LayerNorm scales
    moved off their zero / one init by N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(flat.items()):
        if k.endswith(("alpha_i2t", "alpha_t2i")):
            v = rng.uniform(0.3, 0.7, v.shape).astype(np.float32)
        elif k.endswith(("/bias", "/scale")):
            v = (v + rng.normal(0, 0.02, v.shape)).astype(np.float32)
        out[k] = v
    return out


def load_into(module: torch.nn.Module, flat: Dict[str, np.ndarray],
              flax_prefix: str = "", port_prefix: str = "") -> None:
    """Load a sub-tree into a standalone port module: `flax_prefix` puts
    the paths where they sit inside FiberCoarse, `port_prefix` is then
    stripped from the port's keys."""
    sd = params_from_flax({flax_prefix + k: v for k, v in flat.items()})
    sd = {k[len(port_prefix):]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)


def model_inputs(cfg, n: int, seed: int) -> Tuple[np.ndarray, ...]:
    """Images (n, S, S, 3) fp32, text ids (n, L) and masks (n, L), one
    text padded."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)
                              ).astype(np.float32)
    ids = rng.integers(4, cfg.vocab_size, (n, cfg.max_text_len)
                       ).astype(np.int64)
    masks = np.ones((n, cfg.max_text_len), np.int64)
    masks[n // 2, cfg.max_text_len // 2:] = 0
    ids[masks == 0] = cfg.pad_token_id
    return img, ids, masks


def build_models(seed: int = 0):
    """(jax model, jax variables, port model on the CPU in eval mode, flat
    numpy parameters) at tiny dims with every head."""
    jcfg = JaxFiberConfig.tiny_test(loss_names=LOSSES)
    jmodel = JaxFiberCoarse(jcfg)
    S, L = jcfg.image_size, jcfg.max_text_len
    variables = jmodel.init(
        jax.random.PRNGKey(seed), jnp.ones((1, S, S, 3)),
        jnp.full((1, L), 3, jnp.int32), jnp.ones((1, L), jnp.int32),
        method=JaxFiberCoarse.init_full)
    flat = perturb(flatten(variables["params"]), seed)
    tmodel = FiberCoarse(FiberConfig.tiny_test(loss_names=LOSSES),
                         device="cpu").eval()
    tmodel.load_state_dict(params_from_flax(flat, tmodel), strict=True)
    return jmodel, {"params": unflatten(flat)}, tmodel, flat


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)
