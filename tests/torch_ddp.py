"""Spawning the ranks of a two-process CPU test.

Each rank is a fresh interpreter (`PYTHONPATH` the repo root, one thread)
that imports only `fiber_torch`; it meets the others through a gloo
process group on a `file://` store in the test's `tmp_path` (or through the
`FIBER_*` environment on a bound port), with a timeout on the rendezvous,
on every collective and on the whole run.  A rank that fails or hangs
fails the test, and every rank is killed on the way out.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).resolve().parent / "torch_ddp_worker.py")


def free_port() -> int:
    """A localhost port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("FIBER_COORDINATOR", "FIBER_NUM_PROCESSES", "FIBER_PROCESS_ID",
              "LOCAL_RANK"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def run_ranks(argvs: Sequence[List[str]], envs: Sequence[Dict[str, str]],
              timeout: float = 240.0, cwd=None) -> List[str]:
    """Start one process per argv (with its env), wait for all of them at
    most `timeout` seconds, and return their outputs; fail the test, with
    every output, when one exits non-zero or the time runs out."""
    procs = [subprocess.Popen(argv, env=env, cwd=cwd or ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv, env in zip(argvs, envs)]
    outs: List[str] = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {i} exited {p.returncode}:\n{out[-6000:]}")
    return outs


def run_scenario(scenario: str, inputs: dict, tmp_path, world: int = 2,
                 timeout: float = 240.0) -> List[dict]:
    """`torch_ddp_worker.py`'s `scenario` on `world` ranks over a gloo
    group on a file store: `inputs` saved for them, each rank's outputs
    returned in rank order."""
    d = Path(tmp_path)
    torch.save(inputs, d / "in.pt")
    argvs = [[sys.executable, WORKER, scenario, str(r), str(world), str(d)]
             for r in range(world)]
    run_ranks(argvs, [rank_env()] * world, timeout)
    return [torch.load(d / f"out_rank{r}.pt", weights_only=False)
            for r in range(world)]
