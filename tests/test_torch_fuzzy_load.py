"""The port's fuzzy checkpoint load against `fiber_tpu.utils.fuzzy_load`:
a seeded `tiny_test` port state_dict saved as .pth, .npz and .pkl (under a
`module.` prefix) and loaded through both packages, the JAX side into
`convert_fiber_state_dict` of a port state_dict (no flax init).  Where
JAX's guesses match a key the two agree exactly once the port's result is
converted, resized bias tables included, across a window change; the port
also loads the keys whose torch and flax names JAX cannot pair.  And the
rules: no transposes, leading prefixes stripped only at the start, shape
mismatches skipped and reported, the bicubic resize."""

import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fiber_tpu.utils import checkpoint_convert as jax_convert
from fiber_tpu.utils import fuzzy_load as jax_fuzzy
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.utils import fuzzy_load as fz

torch.set_num_threads(1)

TABLE = "relative_position_bias_table"


def _sd(seed, **kw):
    cfg = FiberConfig.tiny_test(**kw)
    return cfg, FiberCoarse(cfg, device="cpu", seed=seed).state_dict()


def _numpy(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _save(tmp_path, fmt, sd):
    """`sd` under a `module.` prefix, as a Lightning / DDP checkpoint keys
    it, in format `fmt`."""
    wrapped = {f"module.{k}": v for k, v in sd.items()}
    path = str(tmp_path / f"ckpt.{fmt}")
    if fmt == "pth":
        torch.save({"state_dict": wrapped, "epoch": 3}, path)
    elif fmt == "npz":
        np.savez(path, **_numpy(wrapped))
    else:
        with open(path, "wb") as f:
            pickle.dump({"model": _numpy(wrapped)}, f)
    return path


@pytest.mark.parametrize("fmt", ("pth", "npz", "pkl"))
@pytest.mark.parametrize("window_change", (False, True))
def test_fuzzy_load_matches_jax(tmp_path, fmt, window_change):
    _, src = _sd(1)                                 # window 2: 9 table rows
    kw = dict(image_size=96, window_size=3) if window_change else {}
    cfg, dst = _sd(0, **kw)                         # window 3: 25 rows
    path = _save(tmp_path, fmt, src)

    new, report = fz.load_into_state_dict(dst, path)
    assert set(report) == {"matched", "skipped_shape", "unmatched_model"}
    assert report["skipped_shape"] == [] and report["unmatched_model"] == []
    assert sorted(report["matched"]) == sorted(f"{k} <- {fz.strip_key(k)}"
                                               for k in dst)
    w0, w1 = 2, cfg.derived_window_size
    for k, v in new.items():
        assert v.dtype == dst[k].dtype and v.shape == dst[k].shape, k
        want = src[k]
        if TABLE in k:
            want = torch.from_numpy(
                jax_convert.resize_relative_position_bias_table(
                    src[k].numpy(), w0, w1)).float()
        assert torch.equal(v, want), k

    res = cfg.image_size
    params, _ = jax_convert.convert_fiber_state_dict(_numpy(dst), res, res,
                                                     strict=True)
    jax_new, jax_report = jax_fuzzy.load_into_params(params, path)
    ported, _ = jax_convert.convert_fiber_state_dict(_numpy(new), res, res,
                                                     strict=True)
    flat_jax = jax_fuzzy.flatten_params(jax_new)
    flat_port = jax_fuzzy.flatten_params(ported)
    assert set(flat_jax) == set(flat_port)
    matched = [m.split(" <- ")[0] for m in jax_report["matched"]]
    tables = [m for m in matched if TABLE in m]
    assert len(tables) == sum(cfg.swin_depths)
    assert jax_report["skipped_shape"] == []
    for m in matched:
        a, b = flat_port[m], np.asarray(flat_jax[m])
        assert a.dtype == b.dtype, m
        np.testing.assert_array_equal(a, b, err_msg=m)
    # what JAX's torch -> flax guesses leave unmatched, the port loads
    unmatched = set(jax_report["unmatched_model"])
    assert unmatched and unmatched.isdisjoint(matched)
    assert not any(m.startswith("vit_model.") for m in unmatched)


def test_resize_matches_jax_and_torch_bicubic():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((23 * 23, 4)).astype(np.float32)  # w 12
    got = fz.resize_relative_position_bias_table(table, 12, 18)
    want = jax_convert.resize_relative_position_bias_table(table, 12, 18)
    assert got.shape == (35 * 35, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    grid = torch.from_numpy(table).reshape(23, 23, 4).permute(2, 0, 1)[None]
    ref = F.interpolate(grid.double(), size=(35, 35), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0)
    np.testing.assert_allclose(got, ref.reshape(-1, 4).numpy(), atol=1e-5)
    assert fz.resize_relative_position_bias_table(table, 12, 12) is table


def test_fiber_base_tables_resize_529_to_1225():
    """A 384^2 FIBER-Base table (window 12) into a 576^2 one (window 18)."""
    src = {"layers.0.blocks.0.attn.relative_position_bias_table":
           torch.randn(529, 4)}
    dst = {"vit_model.layers.0.blocks.0.attn.relative_position_bias_table":
           torch.zeros(1225, 4)}
    new, report = fz.align_and_update(dst, src)
    assert report["matched"] == [
        "vit_model.layers.0.blocks.0.attn.relative_position_bias_table <- "
        "layers.0.blocks.0.attn.relative_position_bias_table"]
    t = new["vit_model.layers.0.blocks.0.attn.relative_position_bias_table"]
    assert t.shape == (1225, 4) and torch.isfinite(t).all()


def test_square_weight_is_not_transposed():
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    new, report = fz.align_and_update({"proj.weight": torch.zeros(4, 4)},
                                      {"proj.weight": w})
    assert torch.equal(new["proj.weight"], w)
    assert report["matched"] == ["proj.weight <- proj.weight"]


def test_prefix_strip_leading_only(tmp_path):
    """'module.' / 'model.' / 'state_dict.' go only at the start (repeated);
    the tower names anywhere; mid-key 'submodule' / 'text_model' stay."""
    path = str(tmp_path / "m.npz")
    np.savez(path, **{
        "module.some.submodule.weight": np.ones(2),
        "model.text_model.encoder.weight": np.ones(2),
        "state_dict.module.a.module.b": np.ones(2),
        "module.vit_model.norm.weight": np.ones(2),
        "head.text_transformer.x": np.ones(2)})
    sd = fz.load_foreign_state_dict(path)
    assert sorted(sd) == sorted(jax_fuzzy.load_foreign_state_dict(path))
    assert sorted(sd) == ["a.module.b", "head.x", "norm.weight",
                          "some.submodule.weight", "text_model.encoder.weight"]


def test_longest_suffix_picks_the_tower():
    """Stripped tower names land back on their tower: each model key takes
    the loaded key that is its longest suffix."""
    model = {"vit_model.norm.weight": torch.zeros(2),
             "vit_model.layers.0.downsample.norm.weight": torch.zeros(3),
             "text_transformer.embeddings.LayerNorm.weight": torch.zeros(4),
             "cross_modal_text_pooler.dense.weight": torch.zeros(5),
             "itm_score.fc.bias": torch.zeros(2)}
    loaded = {"norm.weight": torch.full((2,), 1.0),
              "layers.0.downsample.norm.weight": torch.full((3,), 2.0),
              "embeddings.LayerNorm.weight": torch.full((4,), 3.0),
              "pooler.dense.weight": torch.full((5,), 4.0),
              "fc.bias": torch.full((2,), 5.0)}
    new, report = fz.align_and_update(model, loaded)
    assert [float(new[k][0]) for k in model] == [1.0, 2.0, 3.0, 0.0, 5.0]
    assert report["unmatched_model"] == [
        "cross_modal_text_pooler.dense.weight"]


def test_shape_mismatch_skipped_and_reported():
    model = {"head.weight": torch.zeros(4, 4),
             "a.attn.relative_position_bias_table": torch.zeros(25, 2),
             "b.attn.relative_position_bias_table": torch.zeros(25, 2)}
    loaded = {"head.weight": torch.ones(7, 3),
              "a.attn.relative_position_bias_table": torch.ones(9, 3),
              "b.attn.relative_position_bias_table": torch.ones(10, 2)}
    new, report = fz.align_and_update(model, loaded)
    assert report["skipped_shape"] == [
        "a.attn.relative_position_bias_table <- "
        "a.attn.relative_position_bias_table",
        "b.attn.relative_position_bias_table <- "
        "b.attn.relative_position_bias_table",
        "head.weight <- head.weight"]
    assert report["matched"] == [] and report["unmatched_model"] == []
    assert all(torch.equal(new[k], model[k]) for k in model)
    # JAX's report has the same keys and the same skip for the head
    _, jreport = jax_fuzzy.align_and_update(
        {"head": {"kernel": np.zeros((4, 4), np.float32)}},
        {"head.weight": np.zeros((7, 3), np.float32)})
    assert set(jreport) == set(report)
    assert jreport["skipped_shape"] == ["head.kernel <- head.weight"]


def test_load_into_model_casts_and_skips_non_tensors(tmp_path):
    """A bf16 Lightning-style checkpoint with non-numeric entries: the
    tensors cast to the model's dtype, the rest ignored."""
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    w = torch.randn(2, 3).bfloat16()
    path = str(tmp_path / "m.pth")
    torch.save({"state_dict": {"model.0.weight": w,
                               "model.0.bias": torch.ones(2),
                               "tag": "run-1"}, "epoch": 1}, path)
    assert sorted(fz.load_foreign_state_dict(path)) == ["0.bias", "0.weight"]
    report = fz.load_into_model(model, path)
    assert sorted(report["matched"]) == ["0.bias <- 0.bias",
                                         "0.weight <- 0.weight"]
    assert model[0].weight.dtype == torch.float32
    assert torch.equal(model[0].weight.data, w.float())
    assert fz.load_into_params is fz.load_into_state_dict
