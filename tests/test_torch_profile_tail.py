"""`fiber_torch/tools/profile_tail.py` at `FiberConfig.tiny_test` sizes on
the CPU: every component builds and runs on its shapes, the three window
attention paths agree, the FLOP counts follow the shapes, and `run` gives
one host-clock row per component."""

import pytest
import torch

from fiber_torch.config import FiberConfig
from fiber_torch.tools import profile_tail as pt

torch.set_num_threads(1)

B = 2


@pytest.fixture(scope="module")
def comps():
    cfg = FiberConfig.tiny_test()
    with torch.inference_mode():
        return cfg, pt.build_components(cfg, B, "cpu", seed=0)


def test_components_run_at_their_shapes(comps):
    cfg, c = comps
    assert tuple(c) == pt.COMPONENTS
    H3, C3 = cfg.stage_resolution(2)[0], cfg.stage_dim(2)
    H4, C4 = cfg.stage_resolution(3)[0], cfg.stage_dim(3)
    with torch.inference_mode():
        out = {name: fn() for name, (fn, _) in c.items()}
    assert out["blk3"].shape == (B, H3, H3, C3)
    assert out["blk4"].shape == (B, H4, H4, C4)
    assert out["txt"].shape == (B, cfg.max_text_len, cfg.text_hidden_size)
    h = cfg.swin_num_heads[2]
    nW, N, C = out["wa"].shape[1:]
    assert out["wa_ker"].shape == (B, nW, h, N, C // h) == out["wa_tr"].shape
    merged = out["wa_ker"].transpose(2, 3).reshape(B, nW, N, C)
    torch.testing.assert_close(merged, out["wa"], rtol=0, atol=1e-6)
    torch.testing.assert_close(out["wa_plain"], out["wa"], rtol=0, atol=0)
    assert all(torch.isfinite(t).all() for t in out.values())


def test_flop_counts_follow_the_shapes(comps):
    cfg, c = comps
    H3, C3 = cfg.stage_resolution(2)[0], cfg.stage_dim(2)
    N, h = cfg.window_size ** 2, cfg.swin_num_heads[2]
    nW = (H3 // cfg.window_size) ** 2
    assert c["wa"][1] == c["wa_ker"][1] == B * 4 * nW * h * N * N * (C3 // h)
    assert c["wa_tr"][1] is None
    plain = pt.swin_block_flops(H3 * H3, C3, N, 4 * C3)
    assert plain == H3 * H3 * (24 * C3 * C3 + 4 * N * C3)
    assert c["blk3"][1] > B * plain       # plus the i2t attention
    assert c["txt"][1] > B * pt.text_layer_flops(
        cfg.max_text_len, cfg.text_hidden_size, cfg.text_intermediate_size)


def test_run_gives_one_host_row_per_component():
    rows = pt.run(FiberConfig.tiny_test(), batch=B, device="cpu", iters=1)
    assert [r["component"] for r in rows] == list(pt.COMPONENTS)
    for r in rows:
        assert r["clock"] == "host" and r["device"] == "cpu"
        assert r["ms"] > 0 and r["ms_per_item"] == r["ms"] / B
        assert (r["tflops"] is None) == (r["component"] == "wa_tr")
