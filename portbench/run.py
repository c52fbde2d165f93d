"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are named in BENCHMARK.json at the
checkout's root; `portbench/harness/runner.py` says what a run does.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
