"""What every cell's run shares: the checkout's layout, the environment
the program runs in, the look for a card, the forbidden modules, seeded
weights, the H100's peaks, and the limits of a cell.

Nothing here imports the program; `run.py` puts the checkout's root on
`sys.path` before an entry does.
"""

from __future__ import annotations

import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

BENCH = Path(__file__).resolve().parent.parent          # portbench/
ROOT = BENCH.parent                                     # the checkout
# the caches of a run, at fixed paths inside the checkout (.gitignore)
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "fiber_tpu")

# published H100 SXM peaks, dense (NVIDIA's data sheet): HBM bytes/s and
# tensor-core FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def prepare_environment() -> None:
    """Caches inside the checkout, no JAX pulled in by a library, and one
    host thread for PyTorch's and numpy's CPU pools (as `torchrun` sets
    them): the host's other cores stay with the process's main thread,
    which issues the device's work."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    each name compared whole (the part before the first dot)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(name: str) -> Tuple[Dict, Dict, Dict, Dict]:
    """(workload entry, configuration file, traffic file, limits file) of
    the cell `name`, each found by its name."""
    m = manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in m["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / cfg["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "limits" / f"{name}.json"))


def derive(seed: int, stream: str) -> int:
    """A seed for one stream of draws of a run, from the run's seed."""
    h = 1469598103934665603
    for ch in f"{seed}/{stream}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h % (1 << 62)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------
def seeded_weights(shapes: Mapping[str, Tuple[int, ...]], seed: int,
                   device, rules: Mapping[str, Any]):
    """Weights for the parameters `shapes` (name -> shape), drawn on
    `device` from `seed` in two calls (one normal, one uniform draw over all
    parameters in name order) and scaled by name: `gates` suffixes uniform
    in [gate_lo, gate_hi], `ones` suffixes 1 + std * normal, `consts`
    suffixes a fixed value, the rest std * normal.  fp32."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    std = rules["std"]
    out, at = {}, 0
    for n, size in zip(names, sizes):
        z, u = normal[at:at + size], uniform[at:at + size]
        at += size
        const = next((v for s, v in rules["consts"].items()
                      if n.endswith(s)), None)
        if const is not None:
            w = torch.full_like(z, float(const))
        elif n.endswith(tuple(rules["gates"])):
            lo, hi = rules["gate_range"]
            w = lo + (hi - lo) * u
        elif n.endswith(tuple(rules["ones"])):
            w = 1.0 + std * z
        else:
            w = std * z
        out[n] = w.view(shapes[n])
    return out


def served(weights: Mapping[str, Any], dtype, keep_fp32: Iterable[str]):
    """The weights as a model served in `dtype` holds them: rounded to it,
    except the parameters named by a `keep_fp32` suffix; in fp32."""
    keep = tuple(keep_fp32)
    return {n: (w if n.endswith(keep) else w.to(dtype).float())
            for n, w in weights.items()}


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------
def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: operations over the type's peak
    or bytes over the memory's rate, whichever is larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# Limits and comparisons
# ---------------------------------------------------------------------------
def norm_gap(prog: Mapping[str, float], ref: Mapping[str, float],
             keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    the median leaf's: (gap, leaf).  `keep` limits the leaves."""
    names = sorted(ref if keep is None else keep)
    ref_norms = sorted(ref[n] for n in names)
    median = ref_norms[len(ref_norms) // 2]
    worst, leaf = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def median_gap(prog: Mapping[str, float], ref: Mapping[str, float]
               ) -> float:
    """The median over the leaves of `norm_gap`'s measure of each leaf."""
    median = sorted(ref.values())[len(ref) // 2]
    gaps = sorted(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
                  for k in ref)
    return gaps[len(gaps) // 2]


def worst_leaves(prog: Mapping[str, float], ref: Mapping[str, float],
                 n: int = 5) -> List[list]:
    """The `n` leaves of the largest gaps by `norm_gap`'s measure:
    [leaf, program's norm, reference's norm, gap]."""
    median = sorted(ref.values())[len(ref) // 2]
    rows = [[k, prog[k], ref[k], abs(prog[k] - ref[k])
             / max(ref[k], median, 1e-30)] for k in ref]
    return sorted(rows, key=lambda r: -r[3])[:n]


def verdict(readings: Mapping[str, float], limits: Mapping[str, float]
            ) -> Tuple[bool, Dict[str, List[float]]]:
    """(every reading within its limit, {name: [reading, limit]}); a
    reading that is missing or not finite is not within."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        checks[name] = [value, limit]
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def print_checks(checks: Mapping[str, List[float]]) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
