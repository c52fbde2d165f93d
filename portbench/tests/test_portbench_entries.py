"""Each entry's loop at tiny sizes on the host's CPU (the command itself
refuses to run without a card): its work counts, the result line's
schema, `correct` on a sound run, and `correct` false with the timed path
broken underneath (a step that leaves its state unchanged; half of each
batch left out, the mean taken over the rest; a mined negative, a rerank
score or a detection's score altered where it is produced; every
detection's box moved by a stride)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import calibrate
from portbench.harness import core, readers, runner
from portbench.harness.trace import Trace
from portbench.tests.tiny import tiny_files

SEED = 2 ** 31 + 977           # larger than 32 signed bits hold
CELLS = [w["name"] for w in core.manifest()["workloads"]]
FAULTS = {"coarse384-pretrain": ("unchanged", "half", "altered"),
          "coarse384-rerank": ("altered",),
          "det800-coco-eval": ("half", "altered", "boxes")}


@pytest.mark.parametrize("cell", CELLS)
def test_entry_runs_and_is_correct(cell):
    res = runner.run_cell(cell, SEED, 0.2, False, "cpu",
                          files=tiny_files(cell))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "readings", "checks"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in runner.metric_specs(cell, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["checks"]) == set(tiny_files(cell)[3])
    json.dumps(res)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    if fault == "unchanged":
        from fiber_torch.train.trainer import CoarseTrainer

        def unchanged(self):
            self.step += 1

        monkeypatch.setattr(CoarseTrainer, "_update", unchanged)
        fault = "program"
    files = tiny_files(cell)
    with calibrate.planted(fault, files[2]["entry"]):
        res = runner.run_cell(cell, SEED + 1, 0.2, False, "cpu", files=files)
    assert not res["correct"], res["checks"]


def _fake_trace(window_s, spans):
    t = Trace(False)
    t.window_s = window_s
    t.starts = np.array([s for s, _, _ in spans], np.int64)
    t.ends = np.array([e for _, e, _ in spans], np.int64)
    t.names = [n for _, _, n in spans]
    ms = 1_000_000
    t.host = (np.array([0, 4 * ms], np.int64), np.array([5 * ms, 5 * ms],
                                                         np.int64),
              ["aten::outer", "aten::inner"])
    return t


def test_readers_on_a_trace():
    ms = 1_000_000
    trace = _fake_trace(0.01, [(0, 2 * ms, "window_attention_fwd_tc_kernel"),
                               (1 * ms, 3 * ms, "gemm"),
                               (6 * ms, 7 * ms, "window_attention_bwd_tc_kernel")])
    assert trace.busy_s == pytest.approx(0.004)
    from portbench.harness.flops import Launch
    x = Launch(2, 4, 144, 16, 32, True)
    run = SimpleNamespace(trace=trace, peak_bytes=3 * 2 ** 30, work={
        "model_flops": 989e12 * 0.001, "k1": [x], "k2": [x]})
    assert readers.mfu(run) == pytest.approx(10.0)
    assert readers.idle_share(run) == pytest.approx(60.0)
    assert readers.peak_gib(run) == pytest.approx(3.0)
    k1 = readers.k1_roofline(run)
    assert 0 < k1 < 100
    gaps = trace.breakdown()["idle_gaps"]
    assert gaps == [["aten::inner", pytest.approx(0.003)]]
    trace.host = (trace.host[0][:0], trace.host[1][:0], [])
    assert trace.breakdown()["idle_gaps"][0][0] == "python, outside torch ops"
    run.work = {"model_flops": 1.0}
    assert readers.k1_roofline(run) is None
