"""Shared set-up of the detection parity tests between `fiber_tpu` and
`fiber_torch`.

The port's parameters are filled from a seeded numpy generator: Linear and
conv weights normal with std 1/sqrt(fan_in), embeddings, relative-position
tables, biases and the prompt N(0, 0.02), norm weights and the head's
`scales` 1 + N(0, 0.02), fusion gates U(0.3, 0.7).  The JAX package's
`convert_detection_state_dict` (strict) carries them to the JAX tree, so no
JAX init is traced or compiled; `jax_param_shapes` gives the JAX tree's
shapes by `jax.eval_shape` for the test that holds the two trees equal.
"""

from __future__ import annotations

from typing import Dict, Tuple

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fiber_tpu.detection.detector import DetectorConfig as JaxDetectorConfig
from fiber_tpu.detection.detector import GroundingDetector as JaxDetector
from fiber_tpu.utils.checkpoint_convert import convert_detection_state_dict
from fiber_torch.detection.detector import DetectorConfig, GroundingDetector

HEAD_KEYS = ("box_cls", "bbox_reg", "centerness", "dot_product_logits")


def flatten(tree) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def unflatten(flat: Dict[str, np.ndarray]):
    return flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def fill(model: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded values for every parameter of a port model (see the module's
    docstring)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, p in sorted(model.state_dict().items()):
        shape = tuple(p.shape)
        if k.endswith(("alpha_i2t", "alpha_t2i")):
            v = rng.uniform(0.3, 0.7, shape)
        elif p.ndim == 1 and k.endswith((".weight", ".scale")):
            v = 1.0 + rng.normal(0, 0.02, shape)        # norms, scales
        elif p.ndim <= 1 or k.endswith(("relative_position_bias_table",
                                        "embeddings.weight",
                                        "tunable_linear.weight")):
            v = rng.normal(0, 0.02, shape)
        else:                                   # a Linear or conv weight
            v = rng.normal(0, int(np.prod(shape[1:])) ** -0.5, shape)
        out[k] = torch.from_numpy(v.astype(np.float32))
    return out


def to_flax(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, np.ndarray]:
    """A port state_dict -> the JAX detector's flat parameters, through the
    JAX package's `convert_detection_state_dict` (strict), and fusion v1's
    two image projections, which it does not map, by hand.  Fusion v1's
    text layers 6-9 are built fused in the JAX package and never fused:
    their gates, which the port does not have, are set to 0."""
    sd = {k: v.numpy() for k, v in sd.items()}
    v1 = {k: sd.pop(k) for k in list(sd)
          if ".cross_modal_image_transform" in k}
    params, _ = convert_detection_state_dict(sd, use_deform=cfg.use_deform,
                                             strict=True)
    flat = flatten(params)
    for k, v in v1.items():
        name, leaf = k.split(".")[-2:]
        flat[f"backbone/{name}/{'kernel' if leaf == 'weight' else 'bias'}"] = (
            v.T if leaf == "weight" else v)
    if cfg.fusion_version == "v1":
        for i in range(12 - cfg.num_fuse_block, 12 - cfg.depths[3]):
            flat[f"backbone/language_backbone/layer_{i}/alpha_t2i"] = (
                np.zeros(1, np.float32))
    return flat


def configs(full: bool = False, **kw
            ) -> Tuple[JaxDetectorConfig, DetectorConfig]:
    """The JAX and the port's configs with the same fields: `tiny_test`, or
    with `full` the defaults (FIBER-B widths)."""
    if full:
        return JaxDetectorConfig(**kw), DetectorConfig(**kw)
    return JaxDetectorConfig.tiny_test(**kw), DetectorConfig.tiny_test(**kw)


def inputs(cfg, B: int, seed: int) -> Dict[str, np.ndarray]:
    """Seeded images and token ids; the second text padded from the
    middle on."""
    rng = np.random.default_rng(seed)
    H, W = cfg.image_size
    T = cfg.max_query_len
    ids = rng.integers(4, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[min(1, B - 1), T // 2:] = 0
    ids[mask == 0] = 1
    return {"images": rng.standard_normal((B, H, W, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "image_sizes": np.tile(np.asarray([[H - 5, W - 9]], np.float32),
                                   (B, 1))}


def jax_param_shapes(jmodel) -> Dict[str, Tuple[int, ...]]:
    """The JAX detector's flat parameter shapes, from `jax.eval_shape` of
    its init (traced, not compiled)."""
    H, W = jmodel.cfg.image_size
    T = jmodel.cfg.max_query_len
    abstract = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.ones((1, T), jnp.int32), jnp.ones((1, T), jnp.int32))
    return {k: tuple(v.shape) for k, v in
            flax.traverse_util.flatten_dict(abstract["params"],
                                            sep="/").items()}


def build_detectors(seed: int = 0, full: bool = False, **kw):
    """(JAX model, its variables, the port model on the CPU, the port's
    state_dict) at `tiny_test` dims (or with `full` FIBER-B's) with `kw`:
    the port's parameters filled from `seed`, carried to the JAX tree by
    `to_flax`."""
    jcfg, tcfg = configs(full, **kw)
    tmodel = GroundingDetector(tcfg, device="cpu")
    sd = fill(tmodel, seed)
    tmodel.load_state_dict(sd, strict=True)
    return (JaxDetector(jcfg), {"params": unflatten(to_flax(sd, tcfg))},
            tmodel, sd)


def jax_forward(jmodel):
    """The JAX detector's apply, jitted once."""
    return jax.jit(lambda v, img, ids, mask: jmodel.apply(v, img, ids, mask))


def port_forward(tmodel, batch) -> Dict:
    with torch.inference_mode():
        return tmodel(torch.from_numpy(batch["images"]),
                      torch.from_numpy(batch["input_ids"]).long(),
                      torch.from_numpy(batch["attention_mask"]).long())


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_heads_match(jout, tout, limit: float = 1e-3) -> None:
    """Every head output at every level, and the language dict, within
    `limit` of each tensor's max-abs."""
    for key in HEAD_KEYS:
        for lvl, (j, t) in enumerate(zip(jout["head_out"][key],
                                         tout["head_out"][key])):
            err = rel_err(t, j)
            assert err <= limit, f"{key}[{lvl}]: {err}"
    for key in ("hidden", "embedded", "aggregate"):
        err = rel_err(tout["lang"][key], jout["lang"][key])
        assert err <= limit, f"lang {key}: {err}"
