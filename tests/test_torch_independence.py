"""`fiber_torch` and `chip_smoke.py` import neither JAX, flax nor anything
of `fiber_tpu`."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fiber_tpu"}
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "fiber_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    bad = [m for m in _imports(ROOT / source)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{source} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Import fiber_torch and every submodule with JAX, flax and fiber_tpu
    made unimportable."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, fiber_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(fiber_torch.__path__,"
        " 'fiber_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 10
