"""Elastic training supervisor: restart on failure, resume from the latest
checkpoint.

The port's copy of `fiber_tpu/train/supervisor.py`.  The reference relies
on AzureML / MPI to relaunch a dead training job and on its
Checkpointer's auto-resume; here a host-side supervisor runs the training
command as a subprocess, restarts it after an abnormal exit with
exponential backoff, and the trainer's `--resume` continues from the last
saved step (`fiber_torch/train/checkpoint.py`):

    python -m fiber_torch.train.supervisor --max-restarts 5 -- \
        python -m fiber_torch.cli --output-dir ckpt --ckpt-every 500 --resume

For a data-parallel run, supervise every rank's process (one supervisor
each, the same `FIBER_*` environment): a restarted rank rejoins the
rendezvous (`fiber_torch/parallel/multihost.py`) when all are back.
"""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


@dataclass
class SuperviseResult:
    attempts: int
    returncode: int
    history: List[int] = field(default_factory=list)


def supervise(cmd: Sequence[str], max_restarts: int = 10,
              backoff_s: float = 5.0, backoff_factor: float = 2.0,
              max_backoff_s: float = 300.0,
              good_exit_codes: Sequence[int] = (0,),
              run: Optional[Callable[[Sequence[str]], int]] = None,
              sleep: Callable[[float], None] = time.sleep,
              log: Callable[[str], None] = lambda m: print(
                  m, file=sys.stderr)) -> SuperviseResult:
    """Run `cmd`, restarting on failure.

    Returns once the command exits with a code in `good_exit_codes` or
    `max_restarts` consecutive failures occur.  `run`/`sleep` are
    injectable for tests; the default `run` is a blocking subprocess.
    """
    if run is None:
        def run(c):
            return subprocess.call(list(c))

    history: List[int] = []
    delay = backoff_s
    for attempt in range(max_restarts + 1):
        rc = run(cmd)
        history.append(rc)
        if rc in good_exit_codes:
            return SuperviseResult(attempts=attempt + 1, returncode=rc,
                                   history=history)
        if attempt == max_restarts:
            break
        log(f"[supervisor] attempt {attempt + 1} exited rc={rc}; "
            f"restarting in {delay:.0f}s (resume from latest checkpoint)")
        sleep(delay)
        delay = min(delay * backoff_factor, max_backoff_s)
    log(f"[supervisor] giving up after {len(history)} attempts")
    return SuperviseResult(attempts=len(history), returncode=history[-1],
                           history=history)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Supervise a training command with auto-restart; the "
                    "wrapped trainer resumes from its latest checkpoint.")
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--backoff", type=float, default=5.0)
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to run (prefix with --)")
    args = p.parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":  # drop only the leading separator: a
        cmd = cmd[1:]           # literal "--" inside the wrapped command
    if not cmd:                 # must pass through untouched
        p.error("no command given")
    res = supervise(cmd, max_restarts=args.max_restarts,
                    backoff_s=args.backoff)
    return res.returncode


if __name__ == "__main__":
    raise SystemExit(main())
