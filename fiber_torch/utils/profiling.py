"""Profiling / FLOPs utilities.

The port's counterpart of `fiber_tpu/utils/profiling.py` (replacements for
the reference's stats hooks, utils/stats.py:19 get_model_complexity_info,
utils/flops.py, Swin.flops()): FLOPs come from one run of the function
under `torch.utils.flop_counter.FlopCounterMode`, traces from
`torch.profiler`.

The four window-attention kernels (K1-K4) launch through ctypes, where a
dispatch mode sees nothing.  Their wrappers call `record_flops` with the
count of the products the plain version runs, so that a model counts the
same FLOPs on the card as on the host, where the plain version's matmuls
are counted op by op (`window_attention_flops`, `window_attention_bwd_flops`,
`fused_swin_blocks_flops`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Iterable, Mapping, Union

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula


@torch.library.custom_op("fiber_torch::count_flops", mutates_args=())
def _count_flops(anchor: torch.Tensor, flops: int) -> torch.Tensor:
    """Does nothing: a dispatch mode sees the call, and FlopCounterMode
    counts `flops` for it (the formula below)."""
    return anchor.new_empty(0)


@register_flop_formula(torch.ops.fiber_torch.count_flops, get_raw=True)
def _count_flops_formula(anchor, flops, *args, out_val=None, **kwargs) -> int:
    return int(flops)


def record_flops(anchor: torch.Tensor, flops: int) -> None:
    """Count `flops` in an active FlopCounterMode (any dispatch mode sees
    the call; with none active this does nothing)."""
    if _get_current_dispatch_mode_stack():
        _count_flops(anchor, int(flops))


def window_attention_flops(B: int, nW: int, N: int, h: int, hd: int) -> int:
    """K1 / K4 forward: q.k^T and P.v, 2 N^2 hd each a (window, head)."""
    return 4 * B * nW * h * N * N * hd


def window_attention_bwd_flops(B: int, nW: int, N: int, h: int,
                               hd: int) -> int:
    """K2: the four products autograd runs through the forward's two (dP,
    dV, dQ, dK); the kernel's recomputed logits are not counted, as
    FlopCounterMode counts no recompute in an attention backward."""
    return 8 * B * nW * h * N * N * hd


def fused_swin_blocks_flops(n: int, B: int, H: int, W: int, C: int,
                            hidden: int, N: int) -> int:
    """K3: per block the qkv, projection and two MLP products over the
    B H W tokens, and the window attention."""
    M = B * H * W
    return n * (2 * M * C * (3 * C + C + 2 * hidden) + 4 * M * N * C)


def compiled_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops": ...} of one call fn(*args, **kwargs), counted by
    FlopCounterMode (matrix products and convolutions; the kernels above
    report their own)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


Params = Union[torch.nn.Module, Mapping[str, torch.Tensor],
               Iterable[torch.Tensor]]


def _tensors(params: Params):
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, Mapping):
        return list(params.values())
    return list(params)


def count_params(params: Params) -> int:
    """Elements of a module's parameters, or of a state_dict's tensors."""
    return sum(int(t.numel()) for t in _tensors(params))


def param_bytes(params: Params) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _tensors(params))


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written as a chrome trace into `logdir` (view with tensorboard
    --logdir, or chrome://tracing)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


def summarize_model(fn: Callable, params: Params,
                    *example_args) -> Dict[str, Any]:
    """Params + FLOPs summary (the reference prints this at startup via
    get_model_complexity_info): fn(*example_args) counted, the parameters
    of `params` (the module fn runs, or its state_dict).  torch counts no
    bytes accessed: `bytes_accessed` is NaN, as JAX's is where its cost
    analysis lacks the key."""
    out = {"params": count_params(params),
           "param_bytes": param_bytes(params)}
    try:
        out["flops"] = compiled_cost(fn, *example_args)["flops"]
        out["bytes_accessed"] = float("nan")
    except Exception as e:  # a function the counter cannot run
        out["cost_analysis_error"] = str(e)
    return out
