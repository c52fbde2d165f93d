"""The port's grounding detector against the JAX package's on the CPU, at
`DetectorConfig.tiny_test(use_deform=True)`, fusion v2: every head output
at every level and the language dict within 1e-3 of each tensor's max-abs
(a text padded), `detection_inference` and the chunked evaluation tool end
to end, the weights' round trip through `convert_detection_state_dict`, and
the `i2t_query_norm` flag.  (`test_torch_detection_fusion.py` holds fusion
v1 and v3, and the parameter trees against JAX's.)"""

import importlib.util
import math
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fiber_tpu.detection.detector as jax_detector
from fiber_tpu.data.tokenizer import WhitespaceTokenizer as JaxTokenizer
from fiber_tpu.detection.postprocess import atss_postprocess as jax_pp
from fiber_tpu.utils.checkpoint_convert import convert_detection_state_dict
from fiber_torch.config import FiberConfig
from fiber_torch.data.tokenizer import WhitespaceTokenizer
from fiber_torch.detection.detector import (DetectorConfig, GroundingDetector,
                                            detection_inference)
from fiber_torch.detection.postprocess import label_to_token_matrix
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.tools.eval_det import evaluate_detection
from fiber_torch.utils.convert import detection_params_from_flax
from torch_detection_parity import (assert_heads_match, build_detectors,
                                    fill, flatten, inputs, jax_forward,
                                    port_forward, rel_err)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NAMES = {1: "person", 2: "dog", 3: "car", 4: "cat", 5: "bus"}
PP = dict(pre_nms_top_n=100, post_nms_top_n=20)


@pytest.fixture(scope="module")
def v2():
    jmodel, variables, tmodel, sd = build_detectors(0, use_deform=True)
    fwd = jax_forward(jmodel)
    batch = inputs(jmodel.cfg, 2, 1)
    jout = fwd(variables, batch["images"], batch["input_ids"],
               batch["attention_mask"])
    # the JAX model as `detection_inference` calls it, through the jitted
    # apply; its postprocess jitted too
    shim = types.SimpleNamespace(
        cfg=jmodel.cfg,
        apply=lambda v, img, ids, mask, deterministic=True: fwd(v, img, ids,
                                                                mask))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel, sd=sd,
                batch=batch, jout=jout, tout=port_forward(tmodel, batch),
                shim=shim)


@pytest.fixture
def jitted_postprocess(monkeypatch):
    monkeypatch.setattr(jax_detector, "atss_postprocess", jax.jit(
        jax_pp, static_argnames=("pre_nms_thresh", "pre_nms_top_n",
                                 "nms_thresh", "post_nms_top_n", "min_size")))


def test_v2_deform_heads_and_lang_match_jax(v2):
    tout = v2["tout"]
    assert len(tout["head_out"]["box_cls"]) == 5
    assert tout["lang"]["embedded"][1, 8:].abs().max() == 0    # padded
    assert_heads_match(v2["jout"], tout)


def test_detection_inference_matches_jax(v2, jitted_postprocess):
    """Every slot of boxes, scores, labels and valid."""
    cfg = v2["jmodel"].cfg
    agg = label_to_token_matrix({1: [1, 2], 2: [4], 3: [6, 7]}, 3,
                                cfg.max_query_len)
    want = jax_detector.detection_inference(v2["shim"], v2["variables"],
                                            v2["batch"], agg, **PP)
    got = detection_inference(v2["tmodel"], v2["batch"], agg, **PP)
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert rel_err(got.boxes, want.boxes) <= 1e-5
    assert rel_err(got.scores, want.scores) <= 1e-5


def test_evaluate_detection_matches_jax_tool(v2, jitted_postprocess):
    """The port's `evaluate_detection` and the JAX tool's, on the same
    weights, images and chunked prompts (two chunks), give equal metrics."""
    spec = importlib.util.spec_from_file_location("jax_eval_det",
                                                  ROOT / "tools/eval_det.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg = v2["jmodel"].cfg
    H, W = cfg.image_size
    rng = np.random.default_rng(2)
    images = rng.standard_normal((4, H, W, 3)).astype(np.float32)
    sizes = np.asarray([[H, W], [50, 60], [H, 40], [30, W]], np.float32)
    gts = [{"boxes": np.array([[4., 4., 40., 40.], [10., 20., 30., 60.]]),
            "labels": np.array([rng.integers(1, 6), rng.integers(1, 6)])}
           for _ in range(4)]
    want = tool.evaluate_detection(v2["shim"], v2["variables"], images,
                                   sizes, NAMES, gts, JaxTokenizer(),
                                   chunk_size=3, batch=2, **PP)
    got = evaluate_detection(v2["tmodel"], images, sizes, NAMES, gts,
                             WhitespaceTokenizer(), chunk_size=3, batch=2,
                             **PP)
    assert set(got) == set(want)
    for k in want:
        assert (math.isnan(got[k]) and math.isnan(want[k])) or \
            got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("use_deform", [True, False])
def test_weights_round_trip(use_deform):
    """A port state_dict -> `convert_detection_state_dict(strict=True)` ->
    `detection_params_from_flax` gives back every tensor exactly."""
    cfg = DetectorConfig.tiny_test(use_deform=use_deform)
    model = GroundingDetector(cfg, device="cpu")
    sd = fill(model, 3)
    params, unmapped = convert_detection_state_dict(
        {k: v.numpy() for k, v in sd.items()}, use_deform=use_deform,
        strict=True)
    assert unmapped == []
    back = detection_params_from_flax(flatten(params), cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    model.load_state_dict(back, strict=True)
    # the other naming of the tower's convs is refused
    with pytest.raises(ValueError, match="use_deform"):
        detection_params_from_flax(
            flatten(params), DetectorConfig.tiny_test(use_deform=not use_deform))


def test_i2t_query_norm_flag():
    """Fusion v1 and v2 blocks have no LayerNorm on the i2t queries, v3's
    and the coarse model's fused blocks have one."""
    def norms(model):
        return [k for k in model.state_dict() if "norm_i2t_i" in k]

    fused = lambda model: [k for k in model.state_dict()
                           if k.endswith("attn.alpha_i2t")]
    for version, has in (("v1", False), ("v2", False), ("v3", True)):
        model = GroundingDetector(
            DetectorConfig.tiny_test(fusion_version=version), device="cpu")
        assert fused(model)
        assert bool(norms(model)) == has, version
        assert len(norms(model)) in (0, 2 * len(fused(model)))
    coarse = FiberCoarse(FiberConfig.tiny_test(), device="cpu")
    assert len(norms(coarse)) == 2 * len(fused(coarse)) > 0


def test_detector_refuses_training_options():
    """The training options build; GLIP's early fusion, long tail, still
    raises."""
    for kw in (dict(mlm_loss=True), dict(use_shallow_contrastive=True),
               dict(use_token_loss=True), dict(use_contrastive_align=True)):
        GroundingDetector(DetectorConfig.tiny_test(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GroundingDetector(DetectorConfig.tiny_test(early_fuse="mha-b"),
                          device="cpu")


def test_port_config_mirrors_jax():
    """Every field of the port's DetectorConfig is one of the JAX one's,
    with the same default; the JAX fields it leaves out are the TPU
    kernel's switch and GLIP's early-fusion switches."""
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(
        jax_detector.DetectorConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(DetectorConfig)}
    assert set(tf) <= set(jf)
    assert set(jf) - set(tf) == {"use_pallas_attention", "lang_model",
                                 "clamp_bertattn",
                                 "use_fused_features_dot_product"}
    for k in tf:
        if k != "compute_dtype":
            assert tf[k] == jf[k], k
    assert DetectorConfig.tiny_test().feat_sizes() == \
        jax_detector.DetectorConfig.tiny_test().feat_sizes()
