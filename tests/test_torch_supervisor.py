"""The port's training supervisor (`fiber_torch/train/supervisor.py`):
restart on failure with backoff, the CLI's separator, and the same
attempts, sleeps and log lines as `fiber_tpu.train.supervisor.supervise`
under one fake runner."""

import sys

import pytest

from fiber_torch.train import supervisor
from fiber_torch.train.supervisor import supervise


def test_restarts_until_success():
    codes = iter([1, 139, 0])
    sleeps = []
    res = supervise(["train"], max_restarts=5, backoff_s=1.0,
                    run=lambda c: next(codes), sleep=sleeps.append,
                    log=lambda m: None)
    assert res.returncode == 0
    assert res.attempts == 3
    assert res.history == [1, 139, 0]
    assert sleeps == [1.0, 2.0]


def test_gives_up_after_max_restarts():
    res = supervise(["train"], max_restarts=2, backoff_s=0.0,
                    run=lambda c: 1, sleep=lambda s: None,
                    log=lambda m: None)
    assert res.returncode == 1
    assert res.attempts == 3


def test_real_subprocess_roundtrip(tmp_path):
    """The first run fails, the second succeeds (a marker file): crash,
    restart, resume."""
    marker = tmp_path / "ran_once"
    script = (f"import os,sys; p=r'{marker}'; "
              "sys.exit(0) if os.path.exists(p) else "
              "(open(p,'w').close(), sys.exit(3))")
    res = supervise([sys.executable, "-c", script], max_restarts=3,
                    backoff_s=0.0, sleep=lambda s: None,
                    log=lambda m: None)
    assert res.returncode == 0
    assert res.history == [3, 0]


def test_cli_strips_only_leading_separator(tmp_path):
    """A literal '--' inside the wrapped command passes through."""
    out = tmp_path / "argv.txt"
    script = f"import sys; open(r'{out}','w').write(' '.join(sys.argv[1:]))"
    rc = supervisor.main(["--max-restarts", "0", "--backoff", "0",
                          "--", sys.executable, "-c", script,
                          "--", "--flag"])
    assert rc == 0
    assert out.read_text() == "-- --flag"


@pytest.mark.parametrize("codes, kw", [
    ([1, 139, 2, 0], dict(max_restarts=5, backoff_s=1.5)),
    ([1] * 8, dict(max_restarts=6, backoff_s=10.0, backoff_factor=3.0,
                   max_backoff_s=100.0)),
    ([7, 0], dict(max_restarts=1, backoff_s=2.0, good_exit_codes=(0, 7))),
])
def test_same_sequence_as_jax(codes, kw):
    """One scripted runner through both supervisors: the same result,
    sleeps and log lines."""
    from fiber_tpu.train.supervisor import supervise as jax_supervise

    def run_with(fn):
        it, sleeps, logs = iter(codes), [], []
        res = fn(["train"], run=lambda c: next(it), sleep=sleeps.append,
                 log=logs.append, **kw)
        return (res.attempts, res.returncode, res.history), sleeps, logs

    assert run_with(supervise) == run_with(jax_supervise)
