"""Tensor parallelism over the mesh's `model` dimension: the port's
`fiber_torch/parallel/tp.py` against the JAX package's
`fiber_tpu/parallel/tp.py`, on gloo ranks on the CPU.

(a) The port's rule equals JAX's `tp_sharding` leaf for leaf through
`flax_path`: JAX's synthetic case, a widened tiny config, and FIBER-Base's
shapes (JAX's from `jax.eval_shape`, the port's model on the meta device).
(b) One fp32 `train_step` of `CoarseTrainer` on a (2, 2) mesh of four
ranks against JAX's step on a (2, 2) mesh of four CPU devices with
`shard_params_tp`: the same weights and the same fixed negatives, as
`tests/test_torch_ddp.py` does.  The config is widened (text width 256,
vocabulary 512) so that a Swin MLP kernel, a text layer's kernels, a
cross-attention kernel and the word embedding are all sharded.
(c) Two model ranks against the port's one process: the steps, the model
peers' replicated parameters, checkpoints both ways, K3's stacked weights.
(d) The errors: a mesh whose size is not the world's, a convolution the
rule shards.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fiber_tpu.config import FiberConfig as JaxFiberConfig
from fiber_tpu.models.fiber import FiberCoarse as JaxFiberCoarse
from fiber_tpu.parallel.itc_queue import ItcQueue as JaxItcQueue
from fiber_tpu.parallel.mesh import create_mesh as jax_mesh
from fiber_tpu.parallel.mesh import shard_batch as jax_shard
from fiber_tpu.parallel.tp import shard_params_tp as jax_shard_params_tp
from fiber_tpu.parallel.tp import tp_sharding as jax_tp_sharding
from fiber_tpu.train.optim import make_optimizer as jax_optimizer
from fiber_tpu.train.trainer import CoarseTrainer as JaxCoarseTrainer
from fiber_tpu.utils.checkpoint_convert import convert_fiber_state_dict
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.objectives import coarse as tobj
from fiber_torch.ops.swin_stage import stack_block_params
from fiber_torch.parallel import tp
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils.convert import _port_key, params_from_flax
from torch_ddp import run_scenario
from torch_parity import (PRETRAIN, flatten, jax_batch, pretrain_batch,
                          to_np)
from test_torch_ddp import _categorical, _gated_state

torch.set_num_threads(1)
ATOL = 1e-4            # gradients and parameters
LOSS_ATOL = 1e-5
KW = dict(warmup_steps=0, learning_rate=1e-4)
# wide enough that every kind of leaf reaches 64K elements: the stage-4
# MLP (128 x 512), the text layers (256 x 1024), the t2i cross-attention's
# query (256 x 256), the i2t text projection (256 x 256), the word
# embedding (512 x 256)
WIDE = dict(text_hidden_size=256, input_text_embed_size=256, vocab_size=512,
            hidden_size=128, loss_names=PRETRAIN, **KW)
B = 4                  # the global batch
NEGATIVES = [np.array([1, 2, 3, 0]), np.array([3, 0, 1, 2])]
KINDS = {"Swin MLP": "vit_model.layers.3.blocks.0.mlp.fc1.weight",
         "text layer": "text_transformer.encoder.layer.0.intermediate."
                       "dense.weight",
         "t2i cross-attention": "text_transformer.encoder.layer.11."
                                "crossattention_t2i.self.query.weight",
         "i2t text projection": "vit_model.layers.3.blocks.1.attn."
                                "qkv_text_i2t.weight",
         "word embedding": "text_transformer.embeddings.word_embeddings."
                           "weight"}


def _torch_dim(flax_axis: int, ndim: int, leaf: str) -> int:
    """The torch axis of a flax leaf's axis (Dense kernels transposed, conv
    HWIO -> OIHW, the rest as they are)."""
    if leaf != "kernel":
        return flax_axis
    if ndim == 2:
        return 1 - flax_axis
    if ndim == 4:
        return (2, 3, 1, 0)[flax_axis]
    return flax_axis


def _jax_plan(shapes, n_model: int) -> dict:
    """JAX's `tp_sharding` over a flax shape tree on a (1, n_model) mesh,
    as {port name: torch dim} of the sharded leaves."""
    specs = jax_tp_sharding(shapes, jax_mesh(jax.devices()[:n_model],
                                             model=n_model))
    out = {}
    for path, spec in flax.traverse_util.flatten_dict(specs, sep="/").items():
        if spec == P():
            continue
        shape = flax.traverse_util.flatten_dict(shapes, sep="/")[path].shape
        name = _port_key(path, np.broadcast_to(np.float32(0), shape))[0]
        out[name] = _torch_dim(list(spec).index("model"), len(shape),
                               path.rsplit("/", 1)[-1])
    return out


def _flax_shapes(cfg, full: bool = True):
    """The JAX model's parameter shapes (traced, not computed): every
    parameter the trainer holds (`init_full`), or the fused forward's."""
    S, L = cfg.image_size, cfg.max_text_len
    method = JaxFiberCoarse.init_full if full else None
    return jax.eval_shape(lambda: JaxFiberCoarse(cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, S, S, 3)),
        jnp.ones((1, L), jnp.int32), jnp.ones((1, L), jnp.int32),
        method=method))["params"]


# ---------------------------------------------------------------------------
# (a) the rule
# ---------------------------------------------------------------------------
def test_rule_matches_jax_synthetic_case():
    """tests/test_tp.py's case on a (2, 4) mesh: a big kernel split on its
    columns, its bias whole, an embedding split on its rows, a kernel whose
    last dimension does not divide whole."""
    shapes = {"mlp": {"kernel": jnp.ones((512, 512)),
                      "bias": jnp.ones((512,))},
              "word_embeddings": {"embedding": jnp.ones((1024, 512))},
              "odd": {"kernel": jnp.ones((512, 510))}}
    m = torch.nn.Module()
    m.mlp = torch.nn.Linear(512, 512)
    m.word_embeddings = torch.nn.Embedding(1024, 512)
    m.odd = torch.nn.Linear(512, 510)
    want = _jax_plan(shapes, 4)
    assert want == {"mlp.weight": 0, "word_embeddings.weight": 0}
    assert tp.tp_sharding(m, 4) == want
    assert tp.tp_sharding(m, 1) == {}


@pytest.mark.parametrize("n_model", [2, 4])
def test_rule_matches_jax_widened_tiny(n_model):
    jcfg = JaxFiberConfig.tiny_test(**WIDE)
    model = FiberCoarse(FiberConfig.tiny_test(**WIDE), device="meta",
                        for_training=True)
    got = tp.tp_sharding(model, n_model)
    assert got == _jax_plan(_flax_shapes(jcfg), n_model)
    for kind, name in KINDS.items():
        assert name in got, kind


@pytest.fixture(scope="module")
def base_shapes():
    """FIBER-Base's flax shapes (the trainer's and the fused forward's)
    and the port's model of them on the meta device."""
    jcfg = JaxFiberConfig.base()
    model = FiberCoarse(FiberConfig.base(), device="meta", for_training=True)
    return _flax_shapes(jcfg), _flax_shapes(jcfg, full=False), model


@pytest.mark.parametrize("n_model,leaves,forward_leaves",
                         [(2, 219, 215), (4, 218, 214)])
def test_rule_matches_jax_at_fiber_base(base_shapes, n_model, leaves,
                                        forward_leaves):
    """Leaf for leaf at FIBER-Base's shapes.  The fused forward's tree
    (278.7 M parameters) has 215 sharded leaves at M = 2 and 214 at M = 4;
    the trainer's (281.3 M: the ITC towers' four dense layers besides) 219
    and 218.  The position embedding (514 rows) is split at M = 2 only."""
    full, forward, model = base_shapes
    got = tp.tp_sharding(model, n_model)
    want = _jax_plan(full, n_model)
    assert got == want
    assert len(got) == leaves
    fwd = _jax_plan(forward, n_model)
    assert len(fwd) == forward_leaves
    assert {k: got[k] for k in fwd} == fwd
    pos = "text_transformer.embeddings.position_embeddings.weight"
    assert (pos in got) == (n_model == 2)
    assert "text_transformer.embeddings.word_embeddings.weight" not in got
    total = sum(p.numel() for p in model.parameters())
    share = tp.local_numel(model, got, n_model) / total
    assert share == pytest.approx({2: 0.6385, 4: 0.4589}[n_model], abs=1e-4)


# ---------------------------------------------------------------------------
# (b) four ranks against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_weights():
    """The widened tiny model's seeded weights (gates moved off 0), its
    queue, and a batch whose two data ranks count different MLM labels."""
    cfg = FiberConfig.tiny_test(**WIDE)
    tr = CoarseTrainer(cfg, device="cpu", seed=0)
    sd = _gated_state(tr.model, 0)
    tr.model.load_state_dict(sd)
    batch = pretrain_batch(cfg, B, seed=1)
    batch["text_labels_mlm"][2:, 2:6] = batch["text_ids"][2:, 2:6]
    batch["text_ids_mlm"][2:, 2:6] = 3
    return dict(cfg=cfg, trainer=tr, model=sd, batch=batch,
                queue={k: v.clone() for k, v in tr.queue.state_dict().items()})


@pytest.fixture(scope="module")
def dp_tp(port_weights, tmp_path_factory):
    """JAX: the grads of its loss_fn with `shard_params_tp` on a (2, 2)
    mesh of four CPU devices (the queue's input rings split over `data`,
    as `shard_state` places them) and its optax update; the port: one
    train_step on a (2, 2) mesh of four gloo ranks."""
    w = port_weights
    params, unmapped = convert_fiber_state_dict(
        {k: v.numpy() for k, v in w["model"].items()}, strict=True)
    assert not unmapped
    jcfg = JaxFiberConfig.tiny_test(**WIDE)
    mesh = jax_mesh(jax.devices()[:4], model=2)
    params = jax_shard_params_tp(jax.tree_util.tree_map(jnp.asarray, params),
                                 mesh)
    jtr = JaxCoarseTrainer(jcfg, mesh=mesh)
    tx = jax_optimizer(jcfg, params)
    queue = JaxItcQueue.create(jax.random.PRNGKey(1), jcfg.itc_queue_size,
                               jcfg.hidden_size, jcfg.image_size,
                               jcfg.max_text_len, input_dtype=jnp.float32)
    queue = queue.replace(**{k: jnp.asarray(v.numpy()) for k, v in
                             w["queue"].items()})
    rows = NamedSharding(mesh, P("data"))
    queue = queue.replace(**{k: jax.device_put(getattr(queue, k), rows)
                             for k in ("image_inputs", "text_inputs",
                                       "text_masks")})
    grad_fn = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
                      static_argnums=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "categorical", _categorical(NEGATIVES))
        (loss, (metrics, _)), grads = grad_fn(
            params, jax_shard(mesh, jax_batch(w["batch"])), queue,
            jax.random.PRNGKey(2), True)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    outs = run_scenario("tp_step", {
        "cfg": WIDE, "model": w["model"], "queue": w["queue"],
        "batch": w["batch"], "negatives": NEGATIVES, "data": 2},
        tmp_path_factory.mktemp("tp22"), world=4)
    return dict(loss=loss, metrics=metrics, grads=grads, params=new_params,
                outs=outs)


def test_dp_tp_losses_match_jax(dp_tp):
    for out in dp_tp["outs"]:
        m = out["metrics"]
        np.testing.assert_allclose(to_np(m["total_loss"]),
                                   to_np(dp_tp["loss"]), atol=LOSS_ATOL)
        for k, v in dp_tp["metrics"].items():
            np.testing.assert_allclose(to_np(m[k]), to_np(v),
                                       atol=LOSS_ATOL, err_msg=k)


def test_dp_tp_shards_every_kind_of_leaf(dp_tp):
    for out in dp_tp["outs"]:
        for kind, name in KINDS.items():
            assert out["plan"].get(name) == 0, kind
            full = out["grads"][name].shape[0]
            assert out["local"][name].shape[0] * 2 == full, kind
        assert out["grad_is_view"]
        assert out["flat_numel"] == out["local_numel"]
        assert out["collectives"]["all_gather"] > 0


def test_dp_tp_grads_match_jax(dp_tp):
    want = params_from_flax(flatten(dp_tp["grads"]))
    for out in dp_tp["outs"]:
        assert set(out["grads"]) == set(want)
        for k in want:
            np.testing.assert_allclose(to_np(out["grads"][k]),
                                       want[k].numpy(), atol=ATOL,
                                       err_msg=k)


def test_dp_tp_params_match_jax(dp_tp):
    want = params_from_flax(flatten(dp_tp["params"]))
    for out in dp_tp["outs"]:
        got = out["state"]["model"]
        for k in want:
            np.testing.assert_allclose(to_np(got[k]), want[k].numpy(),
                                       atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# (c) two model ranks against one process, (d) the errors
# ---------------------------------------------------------------------------
def _fixed_mining():
    calls = []

    def mine(sim, valid, generator, row0=0, total_rows=None):
        idx = torch.as_tensor(NEGATIVES[len(calls) % 2])
        calls.append(1)
        return idx[row0:row0 + sim.shape[0]]
    return mine


def _equal_states(a, b, what):
    """Two trainer states (one process's format) bit-equal."""
    assert a["step"] == b["step"], what
    for part in ("model", "queue"):
        assert set(a[part]) == set(b[part]), (what, part)
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (what, part, k)
    for x, y in zip(a["ema"], b["ema"]):
        assert torch.equal(x, y), what
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert set(sa) == set(sb), what
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (what, i, k)


@pytest.fixture(scope="module")
def one_vs_tp(port_weights, tmp_path_factory):
    """The port's one process: a step from the shared weights (its grads
    and state), then a second step; the same on a (1, 2) mesh, which also
    restores the one process's state after the first step."""
    w = port_weights
    one = CoarseTrainer(w["cfg"], device="cpu", seed=0, ema_decay=0.9)
    one.model.load_state_dict(w["model"])
    one.queue.load_state_dict(w["queue"])
    for e, p in zip(one.ema, one.params):
        e.copy_(p.detach())
    nxt = dict(w["batch"], image=w["batch"]["image"][::-1].copy())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tobj, "mine_hard_negatives", _fixed_mining())
        metrics = one.train_step(w["batch"])
        grads = {n: p.grad.clone() for n, p in one.model.named_parameters()}
        state = copy.deepcopy(one.state_dict())
        stack = stack_block_params(
            one.model.vit_model.layers[3].blocks,
            one.model.vit_model.layers[3].blocks[0].window,
            one.model.vit_model.layers[3].blocks[0].attn.num_heads,
            use_shift=one.model.vit_model.layers[3].blocks[1].shift > 0)
        nxt_metrics = one.train_step(nxt)
    outs = run_scenario("tp_step", {
        "cfg": WIDE, "model": w["model"], "queue": w["queue"],
        "batch": w["batch"], "negatives": NEGATIVES, "data": 1,
        "resume": state, "next": nxt}, tmp_path_factory.mktemp("tp12"))
    return dict(metrics=metrics, grads=grads, state=state, stack=stack,
                next=nxt_metrics, outs=outs)


def test_tp_step_matches_one_process(one_vs_tp):
    r = one_vs_tp
    for out in r["outs"]:
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(to_np(out["metrics"][k]), to_np(v),
                                       atol=LOSS_ATOL, err_msg=k)
        for k, v in r["grads"].items():
            np.testing.assert_allclose(to_np(out["grads"][k]), to_np(v),
                                       atol=ATOL, err_msg=k)


def test_model_peers_agree_bit_for_bit(one_vs_tp):
    """The replicated parameters are bit-equal on the two model ranks,
    though model rank 1's patch-embed gradient was moved by a rounding
    (the trainer takes the whole parameters' gradients from model rank 0),
    the shards differ, and the whole state each rank saves is the same."""
    a, b = one_vs_tp["outs"]
    plan = a["plan"]
    assert plan == b["plan"] and plan
    for k in a["local"]:
        if k in plan:
            assert not torch.equal(a["local"][k], b["local"][k]), k
        else:
            assert torch.equal(a["local"][k], b["local"][k]), k
    _equal_states(a["state"], b["state"], "peers")


def test_one_process_state_resumes_under_tp(one_vs_tp):
    """A one-process state restored on two model ranks saves back bit for
    bit, and its next step matches the one process's."""
    r = one_vs_tp
    for out in r["outs"]:
        _equal_states(out["restored"], r["state"], "restored")
        for k, v in r["next"].items():
            np.testing.assert_allclose(to_np(out["next"][k]), to_np(v),
                                       atol=LOSS_ATOL, err_msg=k)


def test_tp_state_resumes_in_one_process(one_vs_tp):
    """A state saved on two model ranks restores in one process and saves
    back bit for bit."""
    saved = one_vs_tp["outs"][0]["state"]
    one = CoarseTrainer(FiberConfig.tiny_test(**WIDE), device="cpu", seed=3,
                        ema_decay=0.9)
    one.load_state_dict(saved)
    _equal_states(copy.deepcopy(one.state_dict()), saved, "one process")


def test_stacked_blocks_of_a_sharded_model(one_vs_tp):
    """K3's stacked operands from a sharded model are the one process's."""
    want = one_vs_tp["stack"]
    for out in one_vs_tp["outs"]:
        assert set(out["stack"]) == set(want)
        for k, v in want.items():
            assert torch.equal(out["stack"][k], v), k


def test_errors(one_vs_tp):
    for out in one_vs_tp["outs"]:
        assert "2 x 2 mesh over 2 processes" in out["errors"]["mesh"]
        assert "'conv.weight'" in out["errors"]["conv"]
        assert "Conv2d" in out["errors"]["conv"]
