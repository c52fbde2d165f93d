"""The reductions by span (`portbench/harness/spans.py`) on traces built by
hand, `Trace`'s own reductions on a fixed list of events (unchanged by
the spans and by `LinkedTrace`), the idle readers, and on the card
(`cuda`, skipped without one) that the spans share the device's clock."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import core, runner, spans
from portbench.harness.spans import LinkedTrace
from portbench.harness.trace import Trace

US = 1000          # the events below are in ns; their times are read in us


class Event:
    """What `Trace._read` reads of a `KinetoEvent`."""

    def __init__(self, name, start, end, cuda=False, corr=0, note=False):
        self._name, self._start, self._end = name, start * US, end * US
        self._cuda, self._corr, self._note = cuda, corr, note

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._note


def step_events(t, c):
    """One training step at t us: forward [0, 40] launches a kernel that
    runs [10, 20] and one that runs [33, 38]; backward [40, 90] one that
    runs [50, 62] (the idle gap [38, 50] crosses the forward's end) and a
    copy that runs [88, 92], into the update; the update [90, 100] one
    that runs [96, 99]."""
    host = [("train.step", 0, 100), ("train.forward", 0, 40),
            ("aten::mm", 4, 8), ("train.backward", 40, 90),
            ("train.update", 90, 100)]
    launches = [(5, 10, 20, "k_fwd_a"), (30, 33, 38, "k_fwd_b"),
                (45, 50, 62, "k_bwd"), (85, 88, 92, "Memcpy DtoD"),
                (95, 96, 99, "k_update")]
    out = [Event(n, t + s, t + e) for n, s, e in host]
    for i, (at, s, e, n) in enumerate(launches):
        out += [Event("cudaLaunchKernel", t + at, t + at + 1, corr=c + i),
                Event(n, t + s, t + e, cuda=True, corr=c + i)]
    return out


EVENTS = (step_events(0, 1) + step_events(200, 11)
          + [Event("note", 0, 300, note=True),
             Event("gpu note", 0, 300, cuda=True, note=True)])


def traced(kind=Trace, events=EVENTS):
    t = kind(False)
    t._read(events)
    return t


@pytest.mark.parametrize("kind", [Trace, LinkedTrace])
def test_trace_reductions_unchanged(kind):
    t = traced(kind)
    assert t.names == ["k_fwd_a", "k_fwd_b", "k_bwd", "Memcpy DtoD",
                       "k_update"] * 2
    assert t.busy_intervals().tolist() == [
        [a * US, b * US] for a, b in ((10, 20), (33, 38), (50, 62), (88, 92),
                                      (96, 99), (210, 220), (233, 238),
                                      (250, 262), (288, 292), (296, 299))]
    assert t.busy_s == pytest.approx(68e-6)
    assert t.device_s(["k_fwd"]) == pytest.approx(30e-6)
    assert t.by_name()["k_bwd"] == pytest.approx(24e-6)
    gaps = t.breakdown(top=4)["idle_gaps"]
    assert gaps == [["python, outside torch ops", pytest.approx(111e-6)],
                    ["train.backward", pytest.approx(26e-6)],
                    ["train.backward", pytest.approx(26e-6)],
                    ["train.forward", pytest.approx(13e-6)]]
    assert t.breakdown()["device_ops"][0] == ["k_bwd", pytest.approx(24e-6)]
    hs, he, hn = t.host
    assert "note" not in hn and len(hn) == 20


def test_launches_link_by_correlation():
    t = traced(LinkedTrace)
    want = [5, 30, 45, 85, 95, 205, 230, 245, 285, 295]
    assert (t.launch_ns // US).tolist() == want
    orphan = traced(LinkedTrace, [Event("k", 1, 2, cuda=True, corr=99)])
    assert orphan.launch_ns.tolist() == [-1]


@pytest.mark.parametrize("name,idle,busy", [
    ("train.forward", 25, 15), ("train.backward", 36, 16),
    ("train.update", 5, 3), ("train.step", 66, 34)])
def test_busy_and_idle_by_span(name, idle, busy):
    """Inclusive of child spans, and per step (two in the window)."""
    t = traced(LinkedTrace)
    assert spans.count(t, "train.step") == 2
    assert spans.idle_ms(t, name, "train.step") == pytest.approx(idle / US)
    assert spans.busy_ms(t, name, "train.step") == pytest.approx(busy / US)


def test_idle_outside_a_child_span():
    t = traced()
    got = spans.idle_ms(t, "train.step", "train.step",
                        but_not="train.forward")
    assert got == pytest.approx((66 - 25) / US)


def test_no_spans_read_none():
    plain = traced(LinkedTrace, [e for e in EVENTS
                                 if not e.name().startswith("train.")])
    assert spans.count(plain, "train.step") == 0
    assert spans.idle_ms(plain, "train.forward", "train.step") is None
    assert spans.busy_ms(plain, "train.forward", "train.step") is None
    t = traced(LinkedTrace)
    assert spans.idle_ms(t, "train.forward", "det.pass") is None
    assert spans.idle_ms(t, "det.head", "train.step") is None


def test_interval_algebra():
    a = spans.union(torch.tensor([[5, 9], [0, 3], [2, 4], [9, 10]]).numpy())
    assert a.tolist() == [[0, 4], [5, 10]]
    b = spans.union(torch.tensor([[3, 6], [8, 20]]).numpy())
    assert spans.overlap_ns(a, b) == 1 + 1 + 2
    assert spans.minus(a, b).tolist() == [[0, 3], [6, 8]]
    assert spans.overlap_ns(a, spans.union(a[:0])) == 0


DET = [Event("det.call", 0, 100), Event("det.pass", 10, 90),
       Event("det.forward", 20, 60), Event("det.head", 40, 60),
       Event("k_backbone", 25, 45, cuda=True, corr=1),
       Event("k_postprocess", 70, 80, cuda=True, corr=2)]


@pytest.mark.parametrize("metric,events,want", [
    ("forward_idle_ms.train", EVENTS, 25),
    ("backward_idle_ms.train", EVENTS, 36),
    ("head_idle_ms.det", DET, 15), ("tool_idle_ms.det", DET, 20 + 30),
    ("head_idle_ms.det", EVENTS, None), ("forward_idle_ms.train", DET, None)])
def test_idle_readers(metric, events, want):
    mod = runner.load_file(core.BENCH / "metrics" / f"{metric}.py")
    got = mod.read(SimpleNamespace(trace=traced(Trace, events)))
    assert got == (None if want is None else pytest.approx(want / US))


@pytest.mark.cuda
def test_spans_share_the_device_clock_on_the_card():
    """Two spin kernels, each launched in its own span, around a span in
    which the host sleeps 50 ms: the sleeping span holds the device's
    idle time (less the first kernel's tail) and none of its busy time,
    and each kernel's time goes to the span that launched it, even where
    it runs while the host sleeps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans against its clock")
    from fiber_torch.utils.profiling import span
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with LinkedTrace(True) as t:
        with span("clock.first"):
            torch.cuda._sleep(2_000_000)
        with span("clock.sleep"):
            time.sleep(0.05)
        with span("clock.second"):
            torch.cuda._sleep(2_000_000)
    assert len(t.names) == 2          # the two spin kernels, in order
    assert not set(t.names) & {"clock.first", "clock.sleep", "clock.second"}
    d = (t.ends - t.starts) / 1e6
    assert spans.busy_ms(t, "clock.first", "clock.sleep") == pytest.approx(
        d[0])
    assert spans.busy_ms(t, "clock.second", "clock.sleep") == pytest.approx(
        d[1])
    assert spans.busy_ms(t, "clock.sleep", "clock.sleep") == 0
    idle = spans.idle_ms(t, "clock.sleep", "clock.sleep")
    print(f"spin kernels {d.tolist()} ms, idle in the sleep {idle} ms")
    assert 45 <= idle <= 60
