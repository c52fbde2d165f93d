"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface and loaded with `ctypes` (no PyTorch headers, so a build
takes seconds).  Libraries go to `fiber_torch/_build/` (listed in
`.gitignore`), named by a hash of the source, the shared `csrc/*.cuh`
headers and the flags, so that a changed source is rebuilt and an
unchanged one is loaded as it is.  A name may add, after each `+`, a macro
defined for that build: `swin_stage_tf32+FIBER_K3_PHASE_TIMES` is
`csrc/swin_stage_tf32.cu` built with `-DFIBER_K3_PHASE_TIMES`, a library of
its own.
Nothing is built when this module is imported: `load` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# compiler report (registers, shared memory, spills) of each library built
# by this process, by kernel name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(Path(found))
    for c in cand:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _source_and_flags(name: str) -> Tuple[Path, List[str]]:
    base, *defines = name.split("+")
    return CSRC / f"{base}.cu", [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _target(name: str) -> Path:
    src, flags = _source_and_flags(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name.replace('+', '_')}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every library of `names` that is not built yet, one `nvcc`
    per source, all started together.  Returns the seconds each took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, Path, str, subprocess.Popen, float]] = []
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src, flags = _source_and_flags(name)
        cmd = [_nvcc(), *flags, "-o", tmp, str(src)]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter()))
    took: Dict[str, float] = {}
    errors = []
    for name, so, tmp, p, t0 in procs:
        log, _ = p.communicate()
        took[name] = time.perf_counter() - t0
        build_logs[name] = log
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}:\n{log}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The library of `name` (`csrc/<name>.cu`, with the macros after each
    `+` defined), built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
