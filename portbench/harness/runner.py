"""One run of one cell: find its files by name, look for the cards, run
its entry, read its metrics, judge `correct`, print the result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The entry (`portbench/entries/<traffic's entry>.py`, `run(ctx)`) builds
the system under test from the configuration and the seed, warms it up,
calls `ctx.start_window()`, drives it for `ctx.seconds` (inside
`ctx.trace`), reads the device's peak memory, frees the program, and runs
the reference on what the window produced.  It returns the work attempted
and failed, its end-to-end rates, the readings compared with the cell's
limits (`portbench/limits/<cell>.json`), and the work that the per-layer
metrics' readers (`portbench/metrics/<metric>.py`, `read(run)`) count.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Dict, Optional

from portbench.harness import core
from portbench.harness.trace import Trace


def load_file(path: Path) -> ModuleType:
    """A module of the benchmark found by its file name."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What an entry is given: the cell's files, the run's arguments, the
    device, and the clock of the set-up."""

    def __init__(self, name: str, cell, config, traffic, limits, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float,
                 mode: str = "program"):
        self.name, self.cell, self.config = name, cell, config
        self.mode = mode
        self.traffic, self.limits = traffic, limits
        self.seed, self.seconds, self.device = seed, seconds, device
        self.trace = Trace(trace)
        self.t_start = t_start
        self.setup_s: Optional[float] = None

    def start_window(self) -> None:
        """Set-up ends here: every shape of the window is warm."""
        self.setup_s = time.perf_counter() - self.t_start


def metric_specs(cell_name: str, kind: str) -> list:
    """The manifest's `kind` metrics that the cell reports."""
    return [m for m in core.manifest()[kind]
            if cell_name in m.get("workloads", [cell_name])]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             files: Optional[tuple] = None, mode: str = "program"
             ) -> Dict[str, Any]:
    """The result of one run of cell `name` (its files found by name, or
    given as `files`, (cell, config, traffic, limits)).  `mode` "control"
    puts the reference, computed in float8, in the program's place
    (`portbench/calibrate.py`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, config, traffic, limits = files or core.find_cell(name)
    ctx = Context(name, cell, config, traffic, limits, seed, seconds, trace,
                  device, t_start, mode)
    entry = load_file(core.BENCH / "entries" / f"{traffic['entry']}.py")
    out = entry.run(ctx)
    ok, checks = core.verdict(out["readings"], limits)
    result: Dict[str, Any] = {
        "correct": bool(ok and out["failed"] == 0),
        "attempted": int(out["attempted"]), "failed": int(out["failed"])}
    metrics = {}
    if not trace:
        rates = dict(out["rates"], setup_s=ctx.setup_s)
        for spec in metric_specs(name, "end_to_end"):
            if spec["name"] in rates:          # none in a control's run
                metrics[spec["name"]] = {"value": rates[spec["name"]],
                                         "unit": spec["unit"]}
    else:
        run = SimpleNamespace(trace=ctx.trace, work=out["work"],
                              peak_bytes=out["peak_bytes"], config=config,
                              traffic=traffic)
        for spec in metric_specs(name, "per_layer"):
            value = load_file(core.BENCH / "metrics"
                              / f"{spec['name']}.py").read(run)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    result["metrics"] = metrics
    result["device"] = out["device"]
    if trace:
        result["device"].update(busy_s=ctx.trace.busy_s,
                                window_s=ctx.trace.window_s)
        result["breakdown"] = ctx.trace.breakdown()
    result["readings"] = out["readings"]
    result["checks"] = checks
    return result


def device_info(chips: int, peak_bytes: int) -> Dict[str, Any]:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    core.prepare_environment()
    cell = core.find_cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell[0]["chips"]):
        print(f"{args.workload} needs {cell[0]['chips']} CUDA device(s); "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start, cell)
    found = core.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    read = {k: v for k, v in result.pop("readings").items()
            if k not in result["checks"]}
    if read:       # read but not compared (PERF.md says why)
        print("detail " + json.dumps(read), file=sys.stderr)
    core.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0
