"""The reductions that the per-layer metrics' readers share: from the
traced window and the work the entry counted from shapes, to a share of a
peak, of a roofline, or of the window.  Each returns None where it finds
nothing to read."""

from __future__ import annotations

from typing import Optional, Sequence

from portbench.harness import core, flops

# device operations of the window-attention kernels, by name
K1_NAMES = ("window_attention_fwd",)
K2_NAMES = ("window_attention_bwd",)


def mfu(run) -> Optional[float]:
    """% of the bf16 peak: the model FLOPs of the window's work over the
    traced window."""
    if not run.trace.window_s:
        return None
    return (100.0 * run.work["model_flops"] / run.trace.window_s
            / core.PEAK_FLOPS["bfloat16"])


def idle_share(run) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline(run, key: str, names: Sequence[str], count_flops, count_bytes
             ) -> Optional[float]:
    """% of a kernel's roofline: the least time its launches of the
    window's work could take (each launch's operations over the bf16 peak
    or bytes over the memory's rate, whichever is larger) over the device
    time of the operations named `names`."""
    launches = run.work.get(key)
    spent = run.trace.device_s(names)
    if not launches or not spent:
        return None
    least = sum(core.bound_s(count_flops(x), count_bytes(x))
                for x in launches)
    return 100.0 * least / spent


def k1_roofline(run) -> Optional[float]:
    return roofline(run, "k1", K1_NAMES, flops.k1_flops, flops.k1_bytes)


def k2_roofline(run) -> Optional[float]:
    return roofline(run, "k2", K2_NAMES, flops.k2_flops, flops.k2_bytes)


def peak_gib(run) -> Optional[float]:
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None


def span_ms(run, key: str) -> Optional[float]:
    """The mean of a span's device ms over the window's passes."""
    spans = run.work.get(key)
    return sum(spans) / len(spans) if spans else None
