"""No run of a cell loads JAX or the JAX package: each cell's whole path
(the harness, its entry, the program it drives, the reference) runs at
tiny sizes in a fresh process, which then lists the top-level names of its
modules."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import core

CELLS = [w["name"] for w in core.manifest()["workloads"]]
SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.harness import core, runner
from portbench.tests.tiny import tiny_files
core.prepare_environment()
runner.run_cell({cell!r}, 5, 0.1, False, "cpu", files=tiny_files({cell!r}))
print(json.dumps(core.forbidden_modules()))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_no_jax(cell):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(core.ROOT), cell=cell)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
