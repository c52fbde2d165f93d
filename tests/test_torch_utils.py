"""The port's training utilities and tools: the meters' strings against
`fiber_tpu.utils.logging`'s, `count_params` / `param_bytes` against
`fiber_tpu.utils.profiling`'s on the converted tree, `compiled_cost`
against analytic FLOPs (the window-attention ops' own counts among them),
`trace`'s file, and `python -m fiber_torch.tools.eval_all` and
`debug_nan` end to end at tiny dims on the CPU."""

import json
import logging as std_logging
import sys
import time

import numpy as np
import pytest
import torch

from fiber_tpu.utils import checkpoint_convert as jax_convert
from fiber_tpu.utils import logging as jax_logging
from fiber_tpu.utils import profiling as jax_profiling
from fiber_torch import cli
from fiber_torch.config import FiberConfig
from fiber_torch.models.fiber import FiberCoarse
from fiber_torch.ops import swin_stage, window_attention as wa
from fiber_torch.tools import debug_nan, eval_all
from fiber_torch.train.checkpoint import CheckpointManager
from fiber_torch.train.trainer import CoarseTrainer
from fiber_torch.utils import logging as tlog
from fiber_torch.utils import profiling
from fiber_torch.utils.nan_debug import dump_training_state

torch.set_num_threads(1)


def test_meters_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    updates = [{"loss": float(v), "acc": float(a)}
               for v, a in zip(rng.normal(3, 1, 45), rng.random(45))]
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    port, jax = tlog.MetricLogger(), jax_logging.MetricLogger(delimiter="  ")
    assert str(port) == str(jax) == ""
    for n, u in enumerate(updates, 1):
        port.update(**u)
        jax.update(**u)
        if n in (1, 2, 20, 21, 45):
            assert str(port) == str(jax)
    port.update(loss=torch.tensor(2.5))
    jax.update(loss=2.5)
    assert str(port) == str(jax)
    monkeypatch.setattr(time, "time", lambda: 1000.0 + 3725.0)
    for step, total in ((0, 10), (1, 10), (7, 100), (100, 100)):
        assert port.eta(step, total) == jax.eta(step, total)
    for w in (1, 4, 20):
        a, b = tlog.SmoothedValue(w), jax_logging.SmoothedValue(w)
        for v in rng.normal(size=9):
            a.update(float(v))
            b.update(float(v))
            assert (a.median, a.avg, a.global_avg, a.count) == \
                (b.median, b.avg, b.global_avg, b.count)
    empty = tlog.SmoothedValue()
    assert np.isnan(empty.median) and np.isnan(empty.global_avg)


def test_setup_logger_writes_its_file(tmp_path):
    logger = tlog.setup_logger("fiber_torch_test", str(tmp_path), rank=1)
    assert tlog.setup_logger.__defaults__[0] == "fiber_torch"
    logger.info("hello %d", 7)
    for h in logger.handlers:
        h.flush()
    assert not any(isinstance(h, std_logging.StreamHandler)
                   and not isinstance(h, std_logging.FileHandler)
                   for h in logger.handlers)          # rank 1: file only
    assert "hello 7" in (tmp_path / "log.rank1.txt").read_text()
    assert tlog.setup_logger("fiber_torch_test") is logger


def test_tensorboard_writer_is_a_no_op_without_a_backend(tmp_path,
                                                         monkeypatch):
    for m in ("torch.utils.tensorboard", "tensorboard", "tensorflow"):
        monkeypatch.setitem(sys.modules, m, None)
    w = tlog.TensorboardWriter(str(tmp_path))
    w.scalar("loss", 1.0, 0)
    w.flush()
    assert w._writer is None


def test_count_params_and_bytes_match_jax():
    cfg = FiberConfig.tiny_test()
    model = FiberCoarse(cfg, device="cpu", seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree, _ = jax_convert.convert_fiber_state_dict(sd, strict=True)
    n = jax_profiling.count_params(tree)
    assert profiling.count_params(model) == n
    assert profiling.count_params(model.state_dict()) == n
    assert profiling.param_bytes(model) == jax_profiling.param_bytes(tree)
    half = {k: v.bfloat16() for k, v in model.state_dict().items()}
    assert profiling.param_bytes(half) == 2 * n


def test_window_attention_counts_are_the_plain_versions():
    """K1, K4 and K2 report what FlopCounterMode counts for their plain
    versions on the host (forward; autograd's backward)."""
    B, nW, N, h, hd = 2, 3, 16, 2, 8
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, nW, N, 3 * h * hd, generator=g, requires_grad=True)
    bias = torch.randn(nW, h, N, N, generator=g, requires_grad=True)
    fwd = profiling.window_attention_flops(B, nW, N, h, hd)
    assert profiling.compiled_cost(wa.window_attention, qkv, bias, h) == \
        {"flops": float(fwd)}

    def step():
        wa.window_attention(qkv, bias, h).sum().backward()
    assert profiling.compiled_cost(step)["flops"] == \
        fwd + profiling.window_attention_bwd_flops(B, nW, N, h, hd)
    q, k, v = (torch.randn(B, nW, h, N, hd, generator=g) for _ in range(3))
    assert profiling.compiled_cost(wa.window_attention_heads, q, k, v,
                                   bias.detach())["flops"] == fwd


def test_fused_swin_blocks_count_is_the_plain_versions():
    n, B, H, W, C, h, win, hidden = 2, 2, 4, 4, 8, 2, 2, 32
    N = win * win
    g = torch.Generator().manual_seed(1)
    shapes = {"ln1_s": (n, C), "ln1_b": (n, C), "ln2_s": (n, C),
              "ln2_b": (n, C), "qkv_w": (n, 3 * C, C), "qkv_b": (n, 3 * C),
              "proj_w": (n, C, C), "proj_b": (n, C),
              "fc1_w": (n, hidden, C), "fc1_b": (n, hidden),
              "fc2_w": (n, C, hidden), "fc2_b": (n, C),
              "rpb": (n, h, N, N)}
    sp = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    x = torch.randn(B, H, W, C, generator=g)
    mask = torch.zeros(4, N, N)
    with torch.no_grad():
        got = profiling.compiled_cost(swin_stage.fused_swin_blocks, x, sp,
                                      mask, win, h)
    assert got["flops"] == profiling.fused_swin_blocks_flops(
        n, B, H, W, C, hidden, N)


def test_compiled_cost_counts_a_small_model_and_recorded_flops():
    """A linear then the window-attention op: the analytic count; a kernel
    wrapper's `record_flops` adds its count only under a counter."""
    B, nW, N, h, hd = 1, 2, 9, 2, 4
    lin = torch.nn.Linear(h * hd, 3 * h * hd)
    x = torch.randn(B, nW, N, h * hd)
    bias = torch.randn(nW, h, N, N)

    def fn(x):
        out = wa.window_attention(lin(x), bias, h)
        profiling.record_flops(out, 1000)
        return out

    with torch.no_grad():
        got = profiling.compiled_cost(fn, x)["flops"]
    assert got == (2 * B * nW * N * h * hd * 3 * h * hd
                   + profiling.window_attention_flops(B, nW, N, h, hd) + 1000)
    profiling.record_flops(x, 5)                      # no counter: nothing
    summary = profiling.summarize_model(fn, lin, x)
    assert summary["params"] == profiling.count_params(lin) == 8 * 24 + 24
    assert summary["param_bytes"] == 4 * summary["params"]
    assert summary["flops"] == got and np.isnan(summary["bytes_accessed"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    files = list((tmp_path / "tb").glob("*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_eval_all_over_the_clis_checkpoints(tmp_path, capsys):
    """Every checkpoint a tiny CLI run saved: one line a step, finite, the
    last equal to `eval_step` of a trainer restored here on the same
    batch."""
    out = str(tmp_path / "run")
    cli.main(["--tiny", "--device", "cpu", "--steps", "3", "--ckpt-every",
              "1", "--per-device-batch", "2", "--output-dir", out])
    capsys.readouterr()
    rows = eval_all.main(["--dir", out, "--tiny", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    saved = CheckpointManager(out).steps()
    assert saved == [2, 3] and lines == rows
    assert [r["step"] for r in rows] == saved
    assert all(np.isfinite(v) for r in rows for v in r.values())
    cfg = FiberConfig.tiny_test(loss_names=("itm", "mlm", "itc"))
    trainer = CoarseTrainer(cfg, device="cpu", seed=0)
    trainer.load_state_dict(CheckpointManager(out).restore(3))
    batch = next(cli.synthetic_batches(cfg, eval_all.EVAL_BATCH, 0))
    want = eval_all.eval_metrics(trainer, batch, 0)
    assert rows[-1] == {"step": 3, **want}
    assert rows[0] != rows[-1]


def test_debug_nan_replays_a_dump(tmp_path, capsys):
    """A batch with one NaN image, dumped and replayed under both dtypes:
    every term reported, the terms that read the image non-finite."""
    cfg = FiberConfig.tiny_test(loss_names=("itm", "mlm", "itc"))
    batch = next(cli.synthetic_batches(cfg, 3, 0))
    batch["image"][1] = np.nan
    model = FiberCoarse(cfg, device="cpu", seed=0)
    path = dump_training_state(str(tmp_path), 7, batch, model.state_dict())
    report = debug_nan.main([path, "--tiny", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert set(report) == set(printed) == {"float32", "bfloat16"}
    reads_image = {"itc_loss", "itm_loss", "total_loss"}
    if (batch["text_labels_mlm"][1] != -100).any():
        reads_image.add("mlm_loss")
    for dt, terms in report.items():
        assert {"mlm_loss", "itc_loss", "itm_loss", "total_loss"} <= \
            set(terms)
        assert {k for k, (_, finite) in terms.items()
                if k.endswith("_loss") and not finite} == reads_image, dt
        for k, (v, f) in terms.items():
            assert printed[dt][k]["finite"] == f
