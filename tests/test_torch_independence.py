"""`fiber_torch` and `chip_smoke.py` import neither JAX, flax nor anything
of `fiber_tpu`; importing them needs no PIL, pyarrow or transformers (the
card's machine has none)."""

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


def test_imports_need_no_pil_pyarrow_transformers():
    """Every module of fiber_torch, and chip_smoke.py, imports with PIL,
    pyarrow and transformers unimportable, and loads none of them."""
    blocked = sorted(FORBIDDEN | {"PIL", "pyarrow", "transformers"})
    code = (
        "import sys\n"
        f"for m in {blocked!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, fiber_torch\n"
        "for m in pkgutil.walk_packages(fiber_torch.__path__, "
        "'fiber_torch.'): importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"print([m for m in {blocked!r} if sys.modules.get(m) is not None])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


DETECTION = ["fiber_torch/detection/" + m for m in (
    "anchors.py", "boxes.py", "deform_conv.py", "demo.py", "detector.py",
    "dyhead.py", "evaluation.py", "fpn.py", "fusion_backbone.py",
    "postprocess.py")] + ["fiber_torch/data/od_to_grounding.py",
                          "fiber_torch/tools/eval_det.py"]


@pytest.mark.parametrize("source", DETECTION)
def test_detection_modules_are_checked(source):
    """The detection slice's modules are among the sources checked above
    (and so among the modules imported with JAX, PIL, pyarrow and
    transformers blocked)."""
    assert source in SOURCES


DETECTION_TRAINING = ["fiber_torch/detection/" + m for m in (
    "atss.py", "atss_loss.py", "contrastive.py", "losses.py", "mlm.py")] + [
    "fiber_torch/train/detection_trainer.py", "fiber_torch/train/finetune.py",
    "fiber_torch/data/coco_datasets.py", "fiber_torch/data/loader.py",
    "fiber_torch/tools/train_det.py", "fiber_torch/tools/finetune_det.py"]


@pytest.mark.parametrize("source", DETECTION_TRAINING)
def test_detection_training_modules_are_checked(source):
    """The detection training slice's modules are among the sources checked
    above."""
    assert source in SOURCES
