"""The module zoo against `fiber_tpu` on the CPU, fp32, at 1e-5 (of each
output's max-abs, at least 1): `alt_backbones` (the BERT and CLIP text
towers, frozen BatchNorm, a stride-2 Bottleneck, ResNet's four taps at
depth 1 a stage), `backbone_zoo` (MBConv with and without expansion, a
two-unit BiFPN), `fbnet` (the channel shuffle, IRF blocks with a grouped
shuffle, cascaded depthwise convs, SE and a residual, both `Skip`s),
`layers_zoo` (SE, the SE block, EvoNorm with and without its
nonlinearity, DropBlock deterministic and seeded, `PlainDyHead`) and
`language_zoo` (a bidirectional two-layer LSTM and GRUs, with padded
rows).  The JAX modules' parameters are seeded numpy values carried to
the port by `utils/convert.py::zoo_params_from_flax`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiber_tpu.models import alt_backbones as jalt
from fiber_tpu.models import backbone_zoo as jzoo
from fiber_tpu.models import fbnet as jfb
from fiber_tpu.models import language_zoo as jlang
from fiber_tpu.ops import layers_zoo as jlayers
from fiber_torch.models import alt_backbones as talt
from fiber_torch.models import backbone_zoo as tzoo
from fiber_torch.models import fbnet as tfb
from fiber_torch.models import language_zoo as tlang
from fiber_torch.ops import layers_zoo as tlayers
from fiber_torch.utils.convert import zoo_params_from_flax
from torch_zoo_parity import (abstract_params, assert_close, jax_apply,
                              nchw, nhwc, random_params)

torch.set_num_threads(1)
ATOL = 1e-5


def _maps(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def run_pair(family, jm, tm, args, seed=0, nhwc_in=(), nhwc_out=True,
             **kw):
    """JAX's forward and the port's on the same seeded parameters; the
    arguments at `nhwc_in` go to the port NCHW."""
    flat = random_params(abstract_params(jm, *[jnp.asarray(a) for a in args]),
                         seed=seed)
    tm.load_state_dict(zoo_params_from_flax(family, flat, tm, **kw))
    tm.eval()
    want = jax_apply(jm, flat, *[jnp.asarray(a) for a in args])
    targs = [nchw(a) if i in nhwc_in else torch.from_numpy(np.asarray(a))
             for i, a in enumerate(args)]
    with torch.no_grad():
        got = tm(*targs)
    return got, want


def _close_maps(got, want, what):
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(nhwc(g), w, ATOL, f"{what}[{i}]")
    else:
        assert_close(nhwc(got), want, ATOL, what)


# ------------------------------------------------------------ alt_backbones
def test_bert_text_encoder_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 5:] = 0
    kw = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
              max_position_embeddings=16)
    got, want = run_pair("bert_text", jalt.BertTextEncoder(**kw),
                         talt.BertTextEncoder(**kw), (ids, mask))
    assert_close(got, want, ATOL, "bert")


def test_clip_text_encoder_matches_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 50, (2, 7)).astype(np.int32)
    ids[0, 4], ids[1, 6] = 59, 59                       # the EOT tokens
    kw = dict(vocab_size=60, width=32, num_layers=2, num_heads=2,
              context_length=16)
    got, want = run_pair("clip_text", jalt.ClipTextEncoder(**kw),
                         talt.ClipTextEncoder(**kw), (ids,))
    assert_close(got["hidden"], want["hidden"], ATOL, "hidden")
    assert_close(got["aggregate"], want["aggregate"], ATOL, "aggregate")


def test_frozen_batch_norm_and_bottleneck_match_jax():
    x = _maps((2, 8, 10, 16), 3)
    got, want = run_pair("resnet", jalt.FrozenBatchNorm(16),
                         talt.FrozenBatchNorm(16), (x,), nhwc_in=(0,))
    _close_maps(got, want, "frozen bn")
    got, want = run_pair("resnet", jalt.Bottleneck(features=8, stride=2),
                         talt.Bottleneck(16, 8, stride=2), (x,), seed=4,
                         nhwc_in=(0,))
    _close_maps(got, want, "bottleneck")


def test_resnet_taps_match_jax():
    img = _maps((2, 64, 96, 3), 5)
    got, want = run_pair("resnet", jalt.ResNetBackbone(layers=(1, 1, 1, 1)),
                         talt.ResNetBackbone((1, 1, 1, 1)), (img,))
    assert [tuple(g.shape[1:]) for g in got] == [
        (256, 16, 24), (512, 8, 12), (1024, 4, 6), (2048, 2, 3)]
    _close_maps(got, want, "resnet")


# ------------------------------------------------------------- backbone_zoo
@pytest.mark.parametrize("cin,cout,k,stride,e", [
    (16, 16, 3, 1, 1), (16, 24, 5, 2, 6), (24, 24, 3, 1, 6)])
def test_mbconv_matches_jax(cin, cout, k, stride, e):
    x = _maps((2, 8, 10, cin), 6)
    got, want = run_pair(
        "efficientnet", jzoo.MBConv(out_channels=cout, kernel_size=k,
                                    stride=stride, expansion=e),
        tzoo.MBConv(cin, cout, k, stride, e), (x,), nhwc_in=(0,))
    _close_maps(got, want, "mbconv")


def test_bifpn_matches_jax():
    chans = (24, 40, 64)
    taps = [_maps((2, h, w, c), 7 + i)
            for i, ((h, w), c) in enumerate(zip([(16, 24), (8, 12), (4, 6)],
                                                chans))]
    jm = jzoo.BiFPN(channels=64, repeats=2, in_channels=chans)
    tm = tzoo.BiFPN(64, 2, chans)
    flat = random_params(abstract_params(jm, [jnp.asarray(t) for t in taps]),
                         seed=8)
    tm.load_state_dict(zoo_params_from_flax("bifpn", flat, tm))
    want = jax_apply(jm, flat, [jnp.asarray(t) for t in taps])
    with torch.no_grad():
        got = tm([nchw(t) for t in taps])
    assert [tuple(g.shape[-2:]) for g in got] == [(16, 24), (8, 12), (4, 6),
                                                  (2, 3), (1, 2)]
    _close_maps(got, want, "bifpn")


def test_efficientnet_widths_match_jax():
    for v in jzoo.EFFICIENTNET_PARAMS:
        wm = jzoo.EFFICIENTNET_PARAMS[v][0]
        assert tzoo.tap_channels(v) == [jzoo._scale_width(
            jzoo._BASE_STAGES[i][0], wm) for i in (2, 4, 6)]


# -------------------------------------------------------------------- fbnet
def test_channel_shuffle_matches_jax():
    x = _maps((2, 3, 4, 12), 9)
    want = np.asarray(jfb._channel_shuffle(jnp.asarray(x), 3))
    np.testing.assert_array_equal(nhwc(tfb.channel_shuffle(nchw(x), 3)), want)


@pytest.mark.parametrize("op,cin,cout,stride", [
    ("ir_k3_s2", 16, 16, 1), ("ir_k33_e3", 16, 24, 2),
    ("ir_k5_e6_se", 24, 24, 1), ("ir_k7_sep_e1_se", 24, 32, 2)])
def test_irf_block_matches_jax(op, cin, cout, stride):
    e, ker, se, cdw, sh, g = tfb.PRIMITIVES[op]
    assert (e, ker, se, cdw, sh, g) == jfb._PRIMITIVES[op]
    x = _maps((2, 8, 10, cin), 10)
    kw = dict(kernel=ker, se=se, cdw=cdw, shuffle_mid=sh, pw_group=g)
    got, want = run_pair("fbnet", jfb.IRFBlock(cin, cout, e, stride, **kw),
                         tfb.IRFBlock(cin, cout, e, stride, **kw), (x,),
                         nhwc_in=(0,))
    _close_maps(got, want, op)


@pytest.mark.parametrize("cin,cout,stride", [(16, 16, 1), (16, 24, 2)])
def test_skip_matches_jax(cin, cout, stride):
    x = _maps((2, 8, 10, cin), 11)
    jm = jfb.Skip(cin, cout, stride)
    tm = tfb.Skip(cin, cout, stride)
    if cin == cout and stride == 1:
        np.testing.assert_array_equal(nhwc(tm(nchw(x))), x)
        return
    got, want = run_pair("fbnet", jm, tm, (x,), nhwc_in=(0,))
    _close_maps(got, want, "skip")


def test_fbnet_tables_match_jax():
    assert tfb.ARCH_DEFS == {k: [[tuple(b) for b in s] for s in v]
                             for k, v in jfb.ARCH_DEFS.items()}
    assert tfb.PRIMITIVES == jfb._PRIMITIVES
    for n in (5.5, 16, 17.4, 24.5):
        for d in (1, 8):
            assert tfb._get_divisible_by(n, d) == jfb._get_divisible_by(n, d)


# --------------------------------------------------------------- layers_zoo
def test_se_layer_and_block_match_jax():
    x = _maps((2, 6, 7, 32), 12)
    got, want = run_pair("layers_zoo", jlayers.SELayer(32),
                         tlayers.SELayer(32), (x,), nhwc_in=(0,))
    _close_maps(got, want, "se")
    got, want = run_pair("layers_zoo", jlayers.SEBlock(32),
                         tlayers.SEBlock(32), (x,), seed=1, nhwc_in=(0,))
    _close_maps(got, want, "se block")


@pytest.mark.parametrize("nonlinearity", [True, False])
def test_evonorm_matches_jax(nonlinearity):
    x = _maps((2, 6, 7, 32), 13)
    got, want = run_pair(
        "layers_zoo", jlayers.EvoNorm2d(32, groups=8,
                                        nonlinearity=nonlinearity),
        tlayers.EvoNorm2d(32, groups=8, nonlinearity=nonlinearity), (x,),
        nhwc_in=(0,))
    _close_maps(got, want, "evonorm")


def test_drop_block():
    """Deterministic (eval, or rate 0): the identity, as JAX's.  In
    training: blocks of zeros, the rest scaled by the kept share, the same
    draws from the same seed."""
    x = _maps((2, 12, 14, 4), 14)
    want = np.asarray(jlayers.DropBlock2D(0.3, 3).apply({}, jnp.asarray(x)))
    m = tlayers.DropBlock2D(0.3, 3)
    m.eval()
    np.testing.assert_array_equal(nhwc(m(nchw(x))), want)
    np.testing.assert_array_equal(want, x)
    m.train()
    outs = []
    for _ in range(2):
        m.generator = torch.Generator().manual_seed(5)
        outs.append(m(torch.ones(2, 4, 12, 14)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    y = outs[0]
    dropped = y == 0
    assert dropped.any() and (~dropped).any()
    kept = y[~dropped]
    torch.testing.assert_close(kept, torch.full_like(kept, float(kept[0])))
    torch.testing.assert_close(y.mean(), torch.tensor(1.0), rtol=1e-5,
                               atol=1e-5)


def test_plain_dyhead_matches_jax():
    """One DyConv (deformable; the JAX side's compile of the deformable
    gathers is the cost), on levels down to 1 x 2."""
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    feats = [_maps((2, h, w, 32), 15 + i) for i, (h, w) in enumerate(sizes)]
    jm = jlayers.PlainDyHead(channels=32, n_convs=1)
    tm = tlayers.PlainDyHead(32, 32, n_convs=1)
    flat = random_params(abstract_params(jm, [jnp.asarray(f)
                                              for f in feats]), seed=16)
    tm.load_state_dict(zoo_params_from_flax("layers_zoo", flat, tm))
    want = jax_apply(jm, flat, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    _close_maps(got, want, "plain dyhead")


# ------------------------------------------------------------- language_zoo
@pytest.mark.parametrize("rnn_type,bidirectional,n_layers", [
    ("lstm", True, 2), ("gru", False, 1), ("gru", True, 1)])
def test_rnn_language_encoder_matches_jax(rnn_type, bidirectional, n_layers):
    rng = np.random.default_rng(17)
    ids = rng.integers(1, 40, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 4:] = 0
    mask[2, 1:] = 0
    ids[mask == 0] = 0
    kw = dict(vocab_size=40, word_embedding_size=12, word_vec_size=10,
              hidden_size=8, n_layers=n_layers, rnn_type=rnn_type,
              bidirectional=bidirectional)
    got, want = run_pair("rnn", jlang.RNNLanguageEncoder(**kw),
                         tlang.RNNLanguageEncoder(**kw), (ids, mask),
                         bidirectional=bidirectional)
    assert got["hidden"].shape == (3, 7, 8 * (2 if bidirectional else 1))
    for key in ("hidden", "embedded", "aggregate", "final_output"):
        assert_close(got[key], want[key], ATOL, key)
