"""The readings that a cell's limits are set from, over many seeds in one
process: of the program (`--mode program`), of the control (`--mode
control`: the reference computed in float8 in the program's place), and
of the program with a fault planted (`--mode half`: half of each batch
left out; `--mode altered`: one answer of each call altered where it is
produced; `--mode boxes`: every detection's box moved by a stride;
`planted` says how for each entry).

    python3 portbench/calibrate.py --workload <name> --mode <mode> --seeds 1,2,3 [--seconds 2]

Prints one JSON line a seed, then the largest and the smallest reading of
each number.  Runs on the card (as the benchmark does), with the window
cut to `--seconds`.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402
import contextlib  # noqa: E402
from contextlib import contextmanager  # noqa: E402

from portbench.harness import core, runner  # noqa: E402


@contextmanager
def _patched(owner, name: str, make):
    """`owner.name` replaced by `make(original)` while entered."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _half_step(step):
    def half(self, batch, generator=None):
        rows = batch["image"].shape[0] // 2
        return step(self, {k: v[:rows] for k, v in batch.items()}, generator)
    return half


def _altered_scores(rank):
    def altered(*args, **kw):
        scores = rank(*args, **kw).clone()
        scores[0] += scores.abs().max()
        return scores
    return altered


def _altered_negatives(mine):
    def altered(sim, valid, *args, **kw):
        idx = mine(sim, valid, *args, **kw).clone()
        idx[0] = (idx[0] + 1) % valid        # the first row's: the next column
        return idx
    return altered


# the finest level's anchor stride of the detection configurations (px)
STRIDE = 8


def _detections(fault):
    def make(infer):
        def broken(*args, **kw):
            d = infer(*args, **kw)
            if fault == "half":          # the second half of the images
                valid = d.valid.clone()
                valid[valid.shape[0] // 2:] = False
                return d._replace(valid=valid)
            if fault == "boxes":         # every box a stride to the right
                shift = d.boxes.new_tensor([STRIDE, 0, STRIDE, 0])
                return d._replace(boxes=d.boxes + shift)
            scores = d.scores.clone()    # one detection's score
            scores[0, 0] += 0.5
            return d._replace(scores=scores)
        return broken
    return make


def planted(mode: str, entry: str):
    """The program of the entry with the fault of `mode` planted, while
    entered: "half" leaves out half of each batch (the training step's
    mean taken over the rest; the detections of half the images),
    "altered" alters one answer where it is produced (a mined negative, a
    rerank score, a detection's score), and "boxes" moves every detection's
    box by the finest anchor stride."""
    if mode == "half" and entry == "pretrain":
        from fiber_torch.train.trainer import CoarseTrainer
        return _patched(CoarseTrainer, "train_step", _half_step)
    if mode == "altered" and entry == "pretrain":
        from fiber_torch.objectives import coarse
        return _patched(coarse, "mine_hard_negatives", _altered_negatives)
    if mode == "altered" and entry == "rerank":
        from fiber_torch.objectives import retrieval
        return _patched(retrieval, "rank_pairs_pipeline", _altered_scores)
    if mode in ("half", "altered", "boxes") and entry == "detect":
        from fiber_torch.tools import eval_det
        return _patched(eval_det, "detection_inference", _detections(mode))
    if mode in ("program", "control"):
        return contextlib.nullcontext()
    raise ValueError(f"no fault {mode!r} for the entry {entry!r}")


def calibrate(name: str, mode: str, seeds, seconds: float,
              device: str = "cuda", files=None) -> list:
    """Each seed's readings."""
    out = []
    entry = (files or core.find_cell(name))[2]["entry"]
    for seed in seeds:
        with planted(mode, entry):
            res = runner.run_cell(name, seed, seconds, False, device,
                                  files=files,
                                  mode="control" if mode == "control"
                                  else "program")
        row = {"seed": seed, "mode": mode, **res["readings"]}
        print(json.dumps(row), flush=True)
        out.append(row)
        if device != "cpu":
            import torch
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program",
                   choices=("program", "control", "half", "altered",
                            "boxes"))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    core.prepare_environment()
    t0 = time.perf_counter()
    rows = calibrate(args.workload, args.mode,
                     [int(s) for s in args.seeds.split(",")], args.seconds)
    keys = [k for k in rows[0] if k not in ("seed", "mode")]
    print(json.dumps({"mode": args.mode, "seeds": len(rows),
                      "seconds": time.perf_counter() - t0,
                      "max": {k: max(r[k] for r in rows) for k in keys},
                      "min": {k: min(r[k] for r in rows) for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
