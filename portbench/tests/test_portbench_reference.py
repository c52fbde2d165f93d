"""The reference agrees with the port's plain path at tiny sizes on one
set of weights, and groups the parameters for AdamW as the port does."""

import pytest
import torch

from portbench.harness import coarse, core, traffic
from portbench.reference import pretrain as ref_pretrain
from portbench.tests.tiny import tiny_files


@pytest.fixture(scope="module")
def models():
    from fiber_torch.models.fiber import FiberCoarse
    _, config, tr, _ = tiny_files("coarse384-pretrain")
    w = coarse.weights(config, 11, "cpu")
    prog = FiberCoarse(coarse.program_config(config), device="cpu").eval()
    prog.load_state_dict(w)
    ref = coarse.reference_model(config, "cpu").eval()
    ref.load_state_dict(w)
    return config, tr, prog, ref


def test_forward_agrees(models):
    config, tr, prog, ref = models
    m = config["model"]
    gen = traffic.generator(3, "cpu")
    img = traffic.images(gen, 3, m["image_size"], torch.float32, "cpu")
    ids, masks = traffic.texts(gen, 3, m, tr["text_len"], "cpu")
    with torch.no_grad():
        a, b = prog.infer(img, ids, masks), ref.infer(img, ids, masks)
        for k in ("text_feats", "image_feats", "cls_feats"):
            torch.testing.assert_close(a[k], b[k], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(prog.rank_scores(a["cls_feats"]),
                                   ref.rank_scores(b["cls_feats"]))
        for enc, args in (("encode_image_itc", (img,)),
                          ("encode_text_itc", (ids, masks))):
            torch.testing.assert_close(getattr(prog, enc)(*args)["cls_feats"],
                                       getattr(ref, enc)(*args)["cls_feats"],
                                       atol=1e-5, rtol=1e-5)


def test_optimizer_groups_agree(models):
    from fiber_torch.train.optim import lr_at, param_group
    config, _, _, ref = models
    owner = {id(p): mod for mod in ref.modules()
             for p in mod.parameters(recurse=False)}
    for name, p in ref.named_parameters():
        assert ref_pretrain.param_group(name, owner[id(p)]) == param_group(name)
    cfg = coarse.program_config(config)
    for count in (0, 7, 9999, 10000, 10001, 99999, 200000):
        assert ref_pretrain.lr_at(config["optimizer"], 1e-5, count) == \
            pytest.approx(lr_at(cfg, 1e-5, count), rel=1e-12, abs=1e-20)


def test_weights_depend_only_on_the_seed():
    _, config, _, _ = tiny_files("coarse384-pretrain")
    a = coarse.weights(config, 2 ** 33 + 5, "cpu")
    b = coarse.weights(config, 2 ** 33 + 5, "cpu")
    c = coarse.weights(config, 2 ** 33 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    gates = [v for k, v in a.items() if k.endswith("alpha_i2t")]
    assert all(((g >= 0.3) & (g <= 0.7)).all() for g in gates)


def test_detector_agrees():
    from fiber_torch.detection.detector import GroundingDetector
    from portbench.harness.runner import load_file
    from portbench.reference import detector
    entry = load_file(core.BENCH / "entries" / "detect.py")
    _, config, tr, _ = tiny_files("det800-coco-eval")
    m = config["model"]
    w = coarse.weights_of(config, entry.detector_shapes(config), 8, "cpu")
    prog = GroundingDetector(entry.program_config(config), device="cpu")
    prog.load_state_dict(w)
    ref = detector.GroundingDetector(m, "cpu")
    ref.load_state_dict(w)
    gen = traffic.generator(5, "cpu")
    H, W = m["image_size"]
    img = torch.randn((2, H, W, 3), generator=gen)
    tok = traffic.WordTokenizer(m["vocab_size"])
    names = {int(k): v for k, v in tr["classes"].items()}
    caption, agg = detector.prompt(names, sorted(names)[:3], tok,
                                   m["max_query_len"])
    enc = tok.batch([caption] * 2, max_length=m["max_query_len"])
    ids = torch.from_numpy(enc["input_ids"]).long()
    mask = torch.from_numpy(enc["attention_mask"]).long()
    with torch.no_grad():
        a = prog(img, ids, mask)["head_out"]
        b = ref(img, ids, mask)
    for k in ("box_cls", "bbox_reg", "centerness", "dot_product_logits"):
        for x, y in zip(a[k], b[k]):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


def test_prompt_matches_the_tool():
    from fiber_torch.data.od_to_grounding import (build_detection_prompt,
                                                  build_label_to_token_map)
    from fiber_torch.detection.postprocess import label_to_token_matrix
    import numpy as np
    from portbench.reference import detector
    names = {int(k): v for k, v in
             core.load_json(core.BENCH / "traffic" / "coco80-b8.json")
             ["classes"].items()}
    tok = traffic.WordTokenizer(50265)
    for chunk in detector.chunks(names, 40):
        caption, agg = detector.prompt(names, chunk, tok, 256)
        p = build_detection_prompt({l: names[l] for l in chunk}, chunk,
                                   num_negatives=0,
                                   rng=np.random.default_rng(0), shuffle=False)
        l2t = build_label_to_token_map(tok, p, 256)
        want = label_to_token_matrix({i + 1: l2t[l] for i, l in
                                      enumerate(chunk)}, len(chunk), 256)
        assert caption == p.caption
        np.testing.assert_array_equal(agg, want)
