"""Replay a NaN dump under fp32 and bf16 to locate the diverging loss term.

    python -m fiber_torch.tools.debug_nan DUMP.npz
        [--task pretrain_mlm_itm_itc] [--tiny] [--device cuda|cpu]
        [--set KEY=VALUE ...]

The PyTorch counterpart of the JAX repo's `tools/debug_nan.py` (the
reference's replay debugger, fine_grained/tools/train_net.py:150-217
debug_nan): load the (batch, params) that `fiber_torch.utils.nan_debug`
dumped, re-run the coarse pretraining losses once per compute dtype
(`nan_debug.replay` over `nan_debug.trainer_loss_fn`: a fresh
`CoarseTrainer` holding the dumped parameters, `eval_step`), and print
which terms are finite in each as JSON, {dtype: {term: {"value",
"finite"}}}: a NaN only under bf16 points at a precision issue, a NaN in
both at data or state corruption.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from fiber_torch.cli import _parse_overrides
from fiber_torch.config import TASK_PRESETS, FiberConfig
from fiber_torch.utils.nan_debug import replay, trainer_loss_fn


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dump", help=".npz written by nan_debug")
    p.add_argument("--task", default="pretrain_mlm_itm_itc",
                   choices=sorted(TASK_PRESETS))
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--set", nargs="*", metavar="KEY=VALUE", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = TASK_PRESETS[args.task](**_parse_overrides(args.set))
    if args.tiny:
        cfg = FiberConfig.tiny_test(loss_names=cfg.loss_names)
    report = replay(args.dump, trainer_loss_fn(cfg, device=args.device))
    print(json.dumps(
        {dt: {k: {"value": v, "finite": f} for k, (v, f) in terms.items()}
         for dt, terms in report.items()}, indent=2))
    return report


if __name__ == "__main__":
    main()
