"""The benchmark's operation counts: its analytic model FLOPs against
PyTorch's `FlopCounterMode` over the reference at tiny sizes, and K1's /
K2's operations and bytes a launch against the port's and the smoke
script's formulas (frozen here)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import coarse, core, flops, traffic
from portbench.reference import pretrain as ref_pretrain
from portbench.tests.tiny import tiny_files


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def setup():
    _, config, tr, _ = tiny_files("coarse384-pretrain")
    model = coarse.reference_model(config, "cpu")
    model.load_state_dict(coarse.weights(config, 5, "cpu"))
    m = config["model"]
    gen = traffic.generator(7, "cpu")
    B = 3
    img = traffic.images(gen, B, m["image_size"], torch.float32, "cpu")
    ids, masks = traffic.texts(gen, B, m, tr["text_len"], "cpu")
    return config, tr, model, m, img, ids, masks


def test_forward_counts(setup):
    config, tr, model, m, img, ids, masks = setup
    B = img.shape[0]
    with torch.no_grad():
        assert counted(lambda: model.infer(img, ids, masks)) == \
            B * flops.fused_flops(m)
        assert counted(lambda: model.encode_image_trunk(img)) == \
            B * flops.trunk_flops(m)
        assert counted(lambda: model.encode_text_pre(ids, masks)) == \
            B * flops.text_pre_flops(m)
        img_t, txt_t = flops.itc_tower_flops(m)
        assert counted(lambda: model.encode_image_itc(img)) == B * img_t
        assert counted(lambda: model.encode_text_itc(ids, masks)) == B * txt_t


def test_rerank_call_count(setup):
    config, _, model, m, img, ids, masks = setup
    B = img.shape[0]

    def call():
        trunks = model.encode_image_trunk(img)
        text = model.encode_text_pre(ids, masks)
        tail = model.infer_fused_tail(trunks, text, masks)
        model.rank_scores(tail["cls_feats"])

    with torch.no_grad():
        assert counted(call) == flops.rerank_call_flops(m, B, B, B)


def test_pretrain_step_count(setup):
    config, tr, model, m, img, ids, masks = setup
    B = img.shape[0]
    gen = traffic.generator(9, "cpu")
    ids_mlm, labels = traffic.mlm(gen, ids, masks, m, 0.15)
    batch = {"image": img, "text_ids": ids, "text_masks": masks,
             "text_ids_mlm": ids_mlm, "text_labels_mlm": labels}
    Q, S, L = m["itc_queue_size"], m["image_size"], m["max_text_len"]
    rings = {"image_feats": torch.empty(Q, m["hidden_size"]),
             "text_feats": torch.empty(Q, m["hidden_size"]),
             "image_inputs": torch.empty(Q, S, S, 3),
             "text_inputs": torch.empty(Q, L, dtype=torch.long),
             "text_masks": torch.empty(Q, L, dtype=torch.long)}
    traffic.fill_queue(1, rings, m, tr)
    queue = ref_pretrain.Queue(**rings, total=Q)
    model.train()
    opt = ref_pretrain.make_optimizer(model, config["optimizer"])
    try:
        n = counted(lambda: ref_pretrain.train_step(
            model, opt, config["optimizer"], 10000, batch, queue, None,
            traffic.generator(2, "cpu")))
    finally:
        model.eval()
    assert n == flops.pretrain_step_flops(m, B)


LAUNCHES = [flops.Launch(16, 4, 144, 16, 32, True),
            flops.Launch(24, 64, 144, 4, 32, False),
            flops.Launch(2, 476, 144, 4, 32, True)]


@pytest.mark.parametrize("x", LAUNCHES)
def test_kernel_counts(x):
    from fiber_torch.utils.profiling import (window_attention_bwd_flops,
                                             window_attention_flops)
    B, nW, N, h, hd = x.B, x.nW, x.N, x.h, x.hd
    assert flops.k1_flops(x) == window_attention_flops(B, nW, N, h, hd)
    assert flops.k2_flops(x) == window_attention_bwd_flops(B, nW, N, h, hd)
    # chip_smoke.py's counts: bf16 qkv and output, fp32 bias counted once
    # where broadcast over the windows (and dbias written, for K2)
    C, esz = h * hd, 2
    qkv, out = B * nW * N * 3 * C, B * nW * N * C
    bias = (nW if x.shifted else 1) * h * N * N * 4
    assert flops.k1_bytes(x) == qkv * esz + out * esz + bias
    assert flops.k2_bytes(x) == (2 * qkv + out) * esz + bias + nW * h * N * N * 4


def test_launch_counts_match_the_smoke_rule():
    m = core.load_json(core.ROOT / "portbench/configs/fiber-base-384.json")["model"]
    k1, k2 = flops.pretrain_step_launches(m, 8, remat=True)
    assert (len(k1), len(k2)) == (143, 71)        # chip_smoke.expected_launches
    calls = flops.rerank_call_launches(m, 8, 8, 1024, 128)
    assert len(calls) == 18 + 6 * 8


def test_detect_pass_count():
    from portbench.harness.runner import load_file
    from portbench.reference import detector
    entry = load_file(core.BENCH / "entries" / "detect.py")
    cell, config, tr, _ = tiny_files("det800-coco-eval")
    m = {**config["model"], **config["postprocess"],
         "chunk_classes": tr["chunk_size"]}
    model = detector.GroundingDetector(config["model"], "cpu")
    model.load_state_dict(coarse.weights_of(
        config, entry.detector_shapes(config), 3, "cpu"))
    B, T = 2, m["max_query_len"]
    gen = traffic.generator(4, "cpu")
    H, W = m["image_size"]
    img = torch.randn((B, H, W, 3), generator=gen)
    ids = torch.randint(10, m["vocab_size"], (B, T), generator=gen)
    mask = torch.ones(B, T, dtype=torch.long)
    agg = torch.rand((tr["chunk_size"], T), generator=gen)
    sizes = torch.tensor([[H, W]] * B, dtype=torch.float32)
    with torch.no_grad():
        n = counted(lambda: detector.dense(model(img, ids, mask), m, agg,
                                           sizes))
    assert n == B * flops.detect_pass_flops(m)
