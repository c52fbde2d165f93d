"""Fusion v1 and v3 of the port's detector against the JAX package's on
the CPU at `tiny_test` dims, deform off (the fusion versions differ only
in the backbone): every head output at every level and the language dict
within 1e-3 of each tensor's max-abs.  v3 runs with the tunable prompt
(`add_linear_layer`).  The parameter trees, carried to JAX's names, equal
the JAX detector's (`jax.eval_shape` of its init)."""

import dataclasses

import pytest
import torch

from fiber_torch.detection.detector import GroundingDetector
from torch_detection_parity import (assert_heads_match, build_detectors,
                                    flatten, inputs, jax_forward,
                                    jax_param_shapes, port_forward)

torch.set_num_threads(1)

CASES = {"v1": dict(fusion_version="v1"),
         "v3_prompt": dict(fusion_version="v3", add_linear_layer=True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    return build_detectors(1, **CASES[request.param])


def test_heads_and_lang_match_jax(built):
    jmodel, variables, tmodel, _ = built
    batch = inputs(jmodel.cfg, 2, 2)
    jout = jax_forward(jmodel)(variables, batch["images"],
                               batch["input_ids"], batch["attention_mask"])
    assert_heads_match(jout, port_forward(tmodel, batch))


def test_parameter_tree_equals_jax(built):
    """No port parameter without a flax counterpart, and none missing: the
    port's parameters under the JAX detector's names and shapes are its
    init's exactly."""
    jmodel, variables, tmodel, _ = built
    got = {k: tuple(v.shape) for k, v in
           flatten(variables["params"]).items()}
    want = jax_param_shapes(jmodel)
    assert got == want


def test_prompt_is_added_to_the_text():
    """With `add_linear_layer` the prompt is added to the embeddings: a
    zero prompt gives the model without it, a non-zero one moves the
    logits."""
    _, _, tmodel, sd = build_detectors(1, fusion_version="v3",
                                       add_linear_layer=True)
    plain = GroundingDetector(
        dataclasses.replace(tmodel.cfg, add_linear_layer=False), device="cpu")
    plain.load_state_dict({k: v for k, v in sd.items()
                           if "tunable_linear" not in k}, strict=True)
    batch = inputs(tmodel.cfg, 1, 3)
    with_prompt = port_forward(tmodel, batch)["head_out"]
    with torch.no_grad():
        tmodel.fusion_backbone.tunable_linear.weight.zero_()
    zero = port_forward(tmodel, batch)["head_out"]
    without = port_forward(plain, batch)["head_out"]
    for x, y, z in zip(zero["dot_product_logits"],
                       without["dot_product_logits"],
                       with_prompt["dot_product_logits"]):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
        assert not torch.equal(x, z)
