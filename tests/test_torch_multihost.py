"""The port's process groups and host-side gathers
(`fiber_torch/parallel/{multihost,mesh,data_parallel}.py`): the
one-process fallbacks, two gloo ranks on the CPU, the `FIBER_*`
environment contract on a bound port, a configured rendezvous that fails
raising instead of carrying on alone, and `eval_det` split over two
ranks."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from fiber_torch.parallel import data_parallel as dp
from fiber_torch.parallel import mesh as tmesh
from fiber_torch.parallel.multihost import (gather_objects, local_batch_slice,
                                            maybe_initialize_distributed,
                                            merge_eval_predictions,
                                            process_allgather, process_count,
                                            process_index)
from torch_ddp import ROOT, free_port, rank_env, run_ranks, run_scenario

torch.set_num_threads(1)


def test_single_process_fallbacks(monkeypatch):
    """As tests/test_multihost.py::test_single_process_fallbacks."""
    monkeypatch.delenv("FIBER_COORDINATOR", raising=False)
    assert maybe_initialize_distributed() is False
    assert gather_objects({"a": 1}) == [{"a": 1}]
    out = process_allgather(np.arange(6).reshape(2, 3))
    assert out.shape == (1, 2, 3)
    assert local_batch_slice(8) == slice(0, 8)
    assert merge_eval_predictions({3: "x", 5: "y"}) == {3: "x", 5: "y"}
    assert (process_index(), process_count()) == (0, 1)
    assert tmesh.data_group() is None
    batch = {"x": np.arange(4)}
    assert tmesh.shard_batch(batch) == batch


def test_no_group_helpers_are_the_identity():
    x = torch.arange(6.0).reshape(3, 2)
    assert dp.rank_world(None) == (0, 1)
    assert dp.all_gather_rows(x, None) is x
    assert dp.all_gather_rows_grad(x, None) is x
    assert dp.global_count(x, None) is x
    m = {"a": torch.tensor(1.0)}
    assert dp.all_reduce_metrics(m, None) is m
    assert dp.all_gather_objects(3, None) == [3]


def test_mesh_model_axis_is_not_ported():
    """The model axis is ported (`fiber_torch/parallel/tp.py`): a mesh
    with model > 1 needs a process group as every mesh does, and without a
    mesh there is no model group."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.create_mesh(model=2)
    assert tmesh.model_group() is None


def test_flat_grads_stay_views_through_backward():
    """Autograd accumulates into the existing `.grad` in place, so every
    gradient stays a view of the flat buffer one all-reduce covers."""
    lin = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    params = list(lin.parameters())
    flat = dp.flat_grads(params)
    for _ in range(2):
        flat.zero_()
        lin(torch.randn(5, 3)).square().sum().backward()
        assert all(p.grad._base is flat for p in params)
    ref = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    ref.load_state_dict(lin.state_dict())
    x = torch.randn(5, 3)
    flat.zero_()
    lin(x).square().sum().backward()
    ref(x).square().sum().backward()
    torch.testing.assert_close(
        flat, torch.cat([p.grad.reshape(-1) for p in ref.parameters()]),
        rtol=0, atol=0)


def _check_helpers(outs):
    for r, out in enumerate(outs):
        assert [o["rank"] for o in out["objs"]] == [0, 1]
        assert len(out["objs"][1]["payload"]) == 50
        assert out["merged"] == {10: "pred0", 11: "pred1"}
        np.testing.assert_array_equal(
            out["gathered"], np.stack([np.arange(6).reshape(2, 3) + i
                                       for i in range(2)]))
        assert out["slice"] == slice(4 * r, 4 * r + 4)
        assert (out["index"], out["count"]) == (r, 2)
        assert out["mesh"] == ((2, 1), ("data", "model"))
        np.testing.assert_array_equal(out["shard"]["x"],
                                      np.arange(4 * r, 4 * r + 4))
        assert out["shard"]["s"] == np.float32(3)


def test_two_rank_gathers_on_a_file_store(tmp_path):
    _check_helpers(run_scenario("multihost_helpers", {}, tmp_path))


def test_two_rank_env_contract_on_a_bound_port(tmp_path):
    """FIBER_COORDINATOR=127.0.0.1:<port> with FIBER_NUM_PROCESSES and
    FIBER_PROCESS_ID, read by `maybe_initialize_distributed()`."""
    from torch_ddp import WORKER
    torch.save({}, tmp_path / "in.pt")
    coord = f"127.0.0.1:{free_port()}"
    argvs = [[sys.executable, WORKER, "multihost_helpers", str(r), "2",
              str(tmp_path)] for r in range(2)]
    envs = [rank_env({"FIBER_COORDINATOR": coord, "FIBER_NUM_PROCESSES": "2",
                      "FIBER_PROCESS_ID": str(r)}) for r in range(2)]
    run_ranks(argvs, envs)
    _check_helpers([torch.load(tmp_path / f"out_rank{r}.pt",
                               weights_only=False) for r in range(2)])


_UNREACHABLE = r"""
import sys, time
from fiber_torch.parallel.multihost import maybe_initialize_distributed
t0 = time.time()
try:
    maybe_initialize_distributed(backend="gloo", timeout_s=3)
except Exception as e:
    print(f"raised {type(e).__name__} after {time.time() - t0:.1f} s")
    sys.exit(0)
print("carried on alone")
sys.exit(1)
"""


def test_unreachable_coordinator_raises_within_its_timeout():
    """Rank 1 of 2 with no rank 0 listening: the rendezvous raises within
    its timeout; the process never carries on single-process."""
    env = rank_env({"FIBER_COORDINATOR": f"127.0.0.1:{free_port()}",
                    "FIBER_NUM_PROCESSES": "2", "FIBER_PROCESS_ID": "1"})
    res = subprocess.run([sys.executable, "-c", _UNREACHABLE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    seconds = float(res.stdout.split("after ")[1].split(" s")[0])
    assert seconds < 60, res.stdout


_EVAL_DET = ("import runpy, sys\n"
             "sys.modules['transformers'] = None\n"
             "sys.argv = ['eval_det', '--tiny', '--device', 'cpu',"
             " '--num-images', '4', '--chunk-size', '3']\n"
             "runpy.run_module('fiber_torch.tools.eval_det',"
             " run_name='__main__')\n")


def test_two_rank_eval_det_equals_one_process(tmp_path):
    """`eval_det` on two ranks (every other image each, the predictions
    merged before scoring) prints one process's metrics; rank 1 prints
    none."""
    argv = [sys.executable, "-c", _EVAL_DET]
    coord = {"FIBER_COORDINATOR": f"file://{tmp_path}/rdv",
             "FIBER_NUM_PROCESSES": "2"}
    one, rank0, rank1 = run_ranks(
        [argv] * 3, [rank_env()] + [rank_env({**coord,
                                              "FIBER_PROCESS_ID": str(r)})
                                    for r in range(2)])
    last = one.strip().splitlines()[-1]
    assert last.startswith("{") and rank0.strip().splitlines()[-1] == last
    assert "mAP" not in rank1
