"""The coarse training CLI of the port (`fiber_torch/cli.py`) on the CPU:
its batches against `fiber_tpu/cli.py`'s bit for bit, and the loop from
data to checkpoint (train, save, resume, NaN dump) at tiny dims."""

import os
import re
import sys

import numpy as np
import pytest
import torch

from fiber_torch import cli
from fiber_torch.config import FiberConfig
from fiber_torch.data import tokenizer as ttok
from fiber_torch.data.tokenizer import WhitespaceTokenizer
from fiber_torch.utils.nan_debug import load_training_state, replay, \
    trainer_loss_fn

torch.set_num_threads(1)
TINY = ["--tiny", "--device", "cpu", "--per-device-batch", "2",
        "--log-every", "1"]


def test_synthetic_batches_equal_jax():
    from fiber_tpu.cli import synthetic_batches as jax_synthetic
    from fiber_tpu.config import FiberConfig as JaxFiberConfig
    ours = cli.synthetic_batches(FiberConfig.tiny_test(), 3, seed=4)
    theirs = jax_synthetic(JaxFiberConfig.tiny_test(), 3, seed=4)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def arrow_file(tmp_path_factory):
    """A tiny caption arrow file from PNGs of mixed sizes."""
    pytest.importorskip("pyarrow")
    Image = pytest.importorskip("PIL.Image")
    from fiber_torch.data.prepare import make_arrow
    root = tmp_path_factory.mktemp("arrow")
    rng = np.random.default_rng(0)
    recs = []
    for i in range(6):
        p = str(root / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (40 + 9 * i, 70 - 5 * i, 3),
                                     dtype=np.uint8)).save(p)
        recs.append({"image_path": p, "image_id": i, "split": "train",
                     "caption": [f"a photo of thing {i}",
                                 f"another view, number {i}!"]})
    out = str(root / "data.arrow")
    make_arrow(recs, out)
    return out


@pytest.mark.parametrize("device_preprocess", [False, True])
def test_arrow_batches_equal_jax(arrow_file, device_preprocess):
    from fiber_tpu.cli import arrow_batches as jax_arrow
    from fiber_tpu.config import FiberConfig as JaxFiberConfig
    from fiber_tpu.data.tokenizer import WhitespaceTokenizer as JaxTokenizer
    ours = cli.arrow_batches(FiberConfig.tiny_test(), [arrow_file], 4,
                             tokenizer=WhitespaceTokenizer(), seed=2,
                             device_preprocess=device_preprocess)
    theirs = jax_arrow(JaxFiberConfig.tiny_test(), [arrow_file], 4,
                       tokenizer=JaxTokenizer(), seed=2,
                       device_preprocess=device_preprocess)
    for _ in range(4):                # past the end of the first epoch
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        assert ("image_staged" in a) == device_preprocess
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _losses(out: str):
    """{step: total_loss as printed} from the CLI's step lines."""
    return {int(m.group(1)): m.group(2) for m in
            re.finditer(r"^step (\d+) .*total_loss=(\S+)", out, re.M)}


def test_train_checkpoint_and_resume(tmp_path, capsys):
    out = str(tmp_path / "run")
    first = cli.main(TINY + ["--steps", "3", "--output-dir", out,
                             "--ckpt-every", "2"])
    assert sorted(os.listdir(out)) == ["step_2.pt", "step_3.pt"]
    assert first and all(np.isfinite(v) for v in first.values())
    assert set(_losses(capsys.readouterr().out)) == {0, 1, 2}

    again = cli.main(TINY + ["--steps", "5", "--output-dir", out,
                             "--ckpt-every", "2", "--resume"])
    printed = capsys.readouterr().out
    assert "resumed from step 3" in printed
    assert set(_losses(printed)) == {3, 4}
    assert all(np.isfinite(v) for v in again.values())
    assert sorted(os.listdir(out)) == ["step_4.pt", "step_5.pt"]


def test_resumed_step_is_bit_equal(tmp_path, capsys):
    """A run cut after step 2 and resumed takes step 2 as the uninterrupted
    run does, to the bit."""
    whole = cli.main(TINY + ["--steps", "3"])
    capsys.readouterr()
    cut = str(tmp_path / "cut")
    cli.main(TINY + ["--steps", "2", "--output-dir", cut, "--ckpt-every",
                     "2"])
    assert sorted(os.listdir(cut)) == ["step_2.pt"]
    resumed = cli.main(TINY + ["--steps", "3", "--output-dir", cut,
                               "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == whole           # step 2's metrics, float for float


def test_nan_loss_writes_one_dump(tmp_path, monkeypatch):
    """A poisoned batch gives a non-finite loss: one dump, which reads back
    with the batch, the parameters (finite: the guard zeroed the step's
    gradients) and the metrics, and whose replay finds the loss non-finite
    in fp32.  (The ITC queue has then taken the poisoned features, so the
    next ITC steps are non-finite too, in both packages.)"""
    clean = cli.synthetic_batches

    def poisoned(cfg, batch_size, seed=0):
        it = clean(cfg, batch_size, seed)
        first = next(it)
        first["image"][0, 0, 0, 0] = np.inf
        yield first
        yield from it

    monkeypatch.setattr(cli, "synthetic_batches", poisoned)
    out = str(tmp_path / "run")
    last = cli.main(TINY + ["--steps", "1", "--output-dir", out])
    assert not np.isfinite(last["total_loss"])
    dumps = os.listdir(os.path.join(out, "nan_dumps"))
    assert len(dumps) == 1
    path = os.path.join(out, "nan_dumps", dumps[0])
    step, batch, params, metrics = load_training_state(path)
    assert step == 0
    assert set(batch) == {"image", "text_ids", "text_masks", "text_ids_mlm",
                          "text_labels_mlm"}
    assert not np.isfinite(batch["image"]).all()
    cfg = FiberConfig.tiny_test()
    model_keys = cli.CoarseTrainer(cfg, device="cpu").model.state_dict()
    assert set(params) == set(model_keys)
    assert all(np.isfinite(v).all() for v in params.values())
    assert not np.isfinite(metrics["total_loss"])
    report = replay(path, trainer_loss_fn(cfg, device="cpu"),
                    dtypes=("float32",))
    assert report["float32"]["total_loss"][1] is False


def test_arrow_data_with_device_preprocessing_takes_a_step(arrow_file,
                                                           monkeypatch,
                                                           capsys):
    def no_hub(*a, **kw):
        raise OSError("no local tokenizer")

    monkeypatch.setattr(ttok, "load_tokenizer", no_hub)
    calls = []
    finish = cli.finish_batch
    monkeypatch.setattr(cli, "finish_batch",
                        lambda *a: calls.append(1) or finish(*a))
    metrics = cli.main(TINY + ["--steps", "1", "--data", arrow_file])
    assert calls == [1]
    assert all(np.isfinite(v) for v in metrics.values())
    assert set(_losses(capsys.readouterr().out)) == {0}


def test_finish_batch_on_the_batch_device():
    cfg = FiberConfig.tiny_test()
    staged = torch.randint(0, 256, (2, 96, 96, 3), dtype=torch.uint8)
    batch = {"image_staged": staged,
             "image_sizes": torch.tensor([[60, 96], [96, 40]]),
             "text_ids": torch.zeros(2, 4, dtype=torch.long)}
    out = cli.finish_batch(batch, cfg, torch.Generator().manual_seed(0))
    assert set(out) == {"image", "text_ids"}
    assert out["image"].shape == (2, 64, 64, 3)
    assert out["image"].dtype == cfg.compute_dtype
    same = cli.finish_batch(batch, cfg, cli.preprocess_generator("cpu", 0, 3))
    again = cli.finish_batch(batch, cfg, cli.preprocess_generator("cpu", 0, 3))
    torch.testing.assert_close(same["image"], again["image"], rtol=0, atol=0)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--tiny", "--steps", "1"])


# ---------------------------------------------------------------------------
# data parallel: the CLI on two gloo ranks (fiber_torch/parallel/)
def _cli_ranks(tmp_path, name, argv, world=2):
    """`python -m fiber_torch.cli --tiny --device cpu` on `world` ranks
    meeting on a file store; rank 0's output."""
    from torch_ddp import rank_env, run_ranks
    coord = f"file://{tmp_path}/{name}.rdv"
    args = [sys.executable, "-m", "fiber_torch.cli"] + TINY + argv
    envs = [rank_env({"FIBER_COORDINATOR": coord,
                      "FIBER_NUM_PROCESSES": str(world),
                      "FIBER_PROCESS_ID": str(r)}) for r in range(world)]
    return run_ranks([args] * world, envs)[0]


def _params(path):
    return torch.load(path, weights_only=False)["model"]


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_cli")
    out = _cli_ranks(tmp, "whole", ["--per-device-batch", "1", "--steps",
                                    "3", "--output-dir", str(tmp / "whole")])
    return tmp, out


def test_two_rank_run_equals_one_rank(two_rank_run, tmp_path, capsys):
    """Two ranks at batch 1 a rank take the steps one process takes at
    batch 2: the same printed losses and, within fp32 summation order,
    the same parameters."""
    tmp, printed = two_rank_run
    assert "data parallel: 2 processes (gloo)" in printed
    one = str(tmp_path / "one")
    cli.main(TINY + ["--steps", "3", "--output-dir", one])
    assert _losses(capsys.readouterr().out) == _losses(printed)
    want = _params(os.path.join(one, "step_3.pt"))
    got = _params(tmp / "whole" / "step_3.pt")
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-5, msg=k)


def test_two_rank_checkpoint_resumes_bit_equal(two_rank_run):
    """A two-rank run cut after step 2 and resumed on two ranks ends with
    the uninterrupted two-rank run's parameters, to the bit."""
    tmp, _ = two_rank_run
    cut = str(tmp / "cut")
    argv = ["--per-device-batch", "1", "--output-dir", cut]
    _cli_ranks(tmp, "cut", argv + ["--steps", "2", "--ckpt-every", "2"])
    assert sorted(os.listdir(cut)) == ["step_2.pt"]
    printed = _cli_ranks(tmp, "resume", argv + ["--steps", "3", "--resume"])
    assert "resumed from step 2" in printed
    whole = torch.load(tmp / "whole" / "step_3.pt", weights_only=False)
    resumed = torch.load(os.path.join(cut, "step_3.pt"), weights_only=False)
    for k, v in whole["model"].items():
        assert torch.equal(resumed["model"][k], v), k
    for k, v in whole["queue"].items():
        assert torch.equal(resumed["queue"][k], v), k
    assert len(resumed["dropout_generators"]) == 2


def test_configured_group_that_fails_raises(tmp_path):
    """A FIBER_COORDINATOR the rendezvous cannot use (a port out of
    range): the CLI exits with the rendezvous's error and takes no step
    alone.  (An unreachable coordinator raises after its timeout:
    test_torch_multihost.py.)"""
    import subprocess
    from torch_ddp import ROOT, rank_env
    env = rank_env({"FIBER_COORDINATOR": "127.0.0.1:70000",
                    "FIBER_NUM_PROCESSES": "2", "FIBER_PROCESS_ID": "0"})
    res = subprocess.run([sys.executable, "-m", "fiber_torch.cli"] + TINY
                         + ["--steps", "1"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "step 0" not in res.stdout
