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


DATA_PARALLEL = ["fiber_torch/parallel/" + m for m in (
    "multihost.py", "mesh.py", "data_parallel.py", "itc_queue.py")] + [
    "fiber_torch/train/supervisor.py", "fiber_torch/train/checkpoint.py",
    "fiber_torch/train/trainer.py", "fiber_torch/train/detection_trainer.py",
    "fiber_torch/cli.py", "fiber_torch/tools/eval_det.py"]


@pytest.mark.parametrize("source", DATA_PARALLEL)
def test_data_parallel_modules_are_checked(source):
    """The data-parallel slice's modules are among the sources checked
    above."""
    assert source in SOURCES


def test_rank_worker_imports_no_jax():
    """The ranks the data-parallel tests spawn import only the port."""
    worker = ROOT / "tests" / "torch_ddp_worker.py"
    bad = [m for m in _imports(worker) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{worker.name} imports {bad}"


EARLY_FUSION_ZOO = ["fiber_torch/detection/" + m for m in (
    "vlfuse.py", "dyhead.py", "backbones.py")] + [
    "fiber_torch/models/" + m for m in (
        "swin_v2.py", "swin_vl.py", "alt_backbones.py", "backbone_zoo.py",
        "fbnet.py", "language_zoo.py")] + [
    "fiber_torch/ops/layers_zoo.py", "fiber_torch/utils/convert.py"]


@pytest.mark.parametrize("source", EARLY_FUSION_ZOO)
def test_early_fusion_and_zoo_modules_are_checked(source):
    """The early-fusion head's and the backbone zoo's modules are among the
    sources checked above."""
    assert source in SOURCES


def test_early_fusion_and_zoo_modules_import_without_a_card():
    """Each of them imports, and builds its registry, with no CUDA device
    visible and JAX, flax and fiber_tpu unimportable."""
    mods = [s[:-3].replace("/", ".") for s in EARLY_FUSION_ZOO]
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import importlib, torch\n"
        "assert not torch.cuda.is_available()\n"
        f"for n in {mods!r}: importlib.import_module(n)\n"
        "from fiber_torch.detection.backbones import BACKBONES\n"
        "print(len(BACKBONES))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "14"


ROI_AND_DENSE_HEADS = ["fiber_torch/detection/" + m for m in (
    "matcher.py", "roi_align.py", "structures.py", "roi_heads.py",
    "deform_conv.py", "alt_heads.py", "set_loss.py", "box_aug.py")]


@pytest.mark.parametrize("source", ROI_AND_DENSE_HEADS)
def test_roi_and_dense_head_modules_are_checked(source):
    """The ROI side's and the dense heads' modules are among the sources
    checked above."""
    assert source in SOURCES


def test_roi_and_dense_head_modules_import_without_a_card():
    """Each of them imports, and builds a head of each kind on the host,
    with no CUDA device visible and JAX, flax and fiber_tpu
    unimportable."""
    mods = [s[:-3].replace("/", ".") for s in ROI_AND_DENSE_HEADS]
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import importlib, torch\n"
        "assert not torch.cuda.is_available()\n"
        f"for n in {mods!r}: importlib.import_module(n)\n"
        "from fiber_torch.detection import alt_heads, roi_heads\n"
        "heads = [alt_heads.build_head(n, 8, 3, device='cpu') for n in "
        "('RPN', 'RETINA', 'FCOS', 'ATSS')]\n"
        "heads += [roi_heads.BoxHead(8, 3, 16, device='cpu'), "
        "roi_heads.MaskHead(8, 3, 8, device='cpu'), "
        "roi_heads.KeypointHead(8, 3, 8, 2, device='cpu')]\n"
        "try:\n"
        "    roi_heads.BoxHead(8, 3, 16)\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e)\n"
        "else:\n"
        "    raise AssertionError('a head was built on a missing card')\n"
        "print(len(heads))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "7"
