"""harness/spans.py on synthetic traces and records: the device's idle
time split among the program's spans adds up to device_idle's, a gap
goes to the innermost span around its midpoint, and the tracing helper
turns the program's recorder on once a pass and hands over its records.
Then a traced run on the CPU: the warm-up's seconds are read, the
device metrics find nothing to read, and a program without the recorder
leaves every span metric out without raising."""

import builtins
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from graph_detr4d_tpu_torch import tracing
from harness import spans
from harness.cell import load_metric, run_cell
from harness.readers import device_idle
from harness.trace import Trace
from tiny import TINY, bench

SPAN_METRICS = ["backbone_span_ms.serve", "head_span_ms.serve",
                "backbone_idle_ms.serve", "head_idle_ms.serve",
                "engine_idle_ms.serve", "engine_warm_s.serve"]


def ev(name, s, e, dev=DeviceType.CPU, thread=1):
    return NS(name=name, time_range=NS(start=s, end=e), device_type=dev,
              thread=thread)


def trace(device, host, t1=200.0):
    t = Trace.__new__(Trace)
    t.t0, t.t1, t.thread = 0.0, t1, 1
    t.device = [ev("k", s, e, DeviceType.CUDA) for s, e in device]
    t.host = host
    return t


def request_ranges(offset):
    """One request's program ranges: backbone 10-40 and head 50-90 inside
    the request 5-100, and an aten op inside the backbone."""
    o = offset
    return [ev("gd4d::engine.request", o + 5, o + 100),
            ev("gd4d::model.backbone", o + 10, o + 40),
            ev("aten::conv", o + 12, o + 20),
            ev("gd4d::model.head", o + 50, o + 90)]


def test_idle_split_adds_up_to_device_idle():
    # two requests; gaps: 0-6 (mid 3: outside), 8-12 (mid 10: backbone, on
    # its start), 30-34 (backbone), 36-60 (mid 48: engine), 70-72 (head),
    # 80-110 (mid 95: engine), 112-116 (backbone), 130-150 (mid 140:
    # backbone, on its end), 160-200 (mid 180: head)
    busy = [(6, 8), (12, 30), (34, 36), (60, 70), (72, 80), (110, 112),
            (116, 130), (150, 160)]
    t = trace(busy, request_ranges(0) + request_ranges(100)
              + [ev("gd4d::engine.request", 0, 200, thread=2)])
    split = spans.idle_split(t)
    assert split == pytest.approx({"backbone": 32e-6, "head": 42e-6,
                                   "engine": 54e-6, "outside": 6e-6})
    run = NS(trace=t)
    idle_s = device_idle(run) / 100 * t.window_s
    assert sum(split.values()) == pytest.approx(idle_s, rel=1e-12)
    run = NS(trace=t, traced_requests=2, state={})
    assert spans.idle_ms(run, "head") == pytest.approx(1e3 * 42e-6 / 2)


def test_gap_on_a_span_edge_goes_to_the_innermost_span():
    host = [ev("gd4d::engine.request", 0, 100), ev("gd4d::model.head", 50, 80)]
    # gap 40-60: midpoint 50, the head's start; gap 70-90: midpoint 80,
    # its end; gap 95-100: the request alone
    t = trace([(0, 40), (60, 70), (90, 95)], host, t1=100.0)
    assert spans.idle_split(t) == pytest.approx(
        {"backbone": 0.0, "head": 40e-6, "engine": 5e-6, "outside": 0.0})
    # a nested span that starts with its parent is still the inner one
    t = trace([(10, 100)], [ev("gd4d::engine.request", 0, 100),
                            ev("gd4d::model.backbone", 0, 20)], t1=100.0)
    assert spans.idle_split(t)["backbone"] == pytest.approx(10e-6)


def test_idle_split_needs_device_events_and_a_request():
    assert spans.idle_split(trace([], request_ranges(0))) is None
    assert spans.idle_split(trace([(0, 5)], [ev("aten::mm", 0, 9)])) is None


def test_install_turns_tracing_on_once_a_pass_and_keeps_the_records():
    run = NS(state={}, cleanups=[])
    tracing.drain()
    with tracing.span("engine.warm.infer", always=True):
        pass
    for _ in range(3):  # three metrics of one pass
        spans.install(run, profiled=False)
    assert tracing.RECORDER.enabled and len(run.cleanups) == 1
    with tracing.span("engine.request"):
        pass
    run.cleanups.pop()()
    assert not tracing.RECORDER.enabled
    assert [r.name for r in run.state[spans.SETUP]] == ["engine.warm.infer"]
    assert [r.name for r in run.state[spans.UNPROFILED]] == ["engine.request"]
    spans.install(run, profiled=True)
    with tracing.span("model.head"):
        pass
    run.cleanups.pop()()
    assert [r.name for r in run.state[spans.PROFILED]] == ["model.head"]
    assert [r.name for r in run.state[spans.SETUP]] == ["engine.warm.infer"]
    assert spans.warm_s(run) == pytest.approx(
        (run.state[spans.SETUP][0].end_ns - run.state[spans.SETUP][0].start_ns)
        / 1e9)


def test_span_ms_refuses_a_pass_that_dropped_records():
    """A sum over a buffer that overflowed would read low: no number."""
    run = NS(state={}, cleanups=[])
    tracing.drain()
    spans.install(run, profiled=False)
    with tracing.span("model.head"):
        pass
    dropped = tracing.RECORDER.dropped
    try:
        tracing.RECORDER.dropped = dropped + 1
        run.cleanups.pop()()
    finally:
        tracing.RECORDER.dropped = dropped
    assert run.state[spans.DROPPED] == dropped + 1
    for r in run.state[spans.UNPROFILED]:  # as if on a card
        r.events = object()
    run.traced_requests = 1
    assert spans.span_ms(run, "model.head") is None


def test_warm_s_reads_the_last_engine_warm_up():
    def rec(name, start, end):
        return NS(name=name, start_ns=start, end_ns=end)

    run = NS(state={spans.SETUP: [
        rec("engine.warm.infer", 0, 10 ** 9),  # an earlier Engine
        rec("engine.warm.infer", 0, 2 * 10 ** 9),
        rec("engine.warm.infer_stream", 0, 5 * 10 ** 8)]})
    assert spans.warm_s(run) == pytest.approx(2.5)
    assert spans.warm_s(NS(state={})) is None


def run_traced():
    result, _ = run_cell(bench(), "flagship_stream", 2 ** 31 + 77, 0.5, 1, "cpu",
                         overrides=TINY)
    return result


def test_traced_run_reads_the_warm_up_and_leaves_tracing_off():
    result = run_traced()
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert got["engine_warm_s.serve"]["value"] > 0
    assert got["engine_warm_s.serve"]["unit"] == "s"
    # no CUDA events and no device trace on the CPU
    for name in SPAN_METRICS[:5]:
        assert name not in got
    assert not tracing.RECORDER.enabled


def test_program_without_the_recorder_reads_nothing(monkeypatch):
    real_import = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "graph_detr4d_tpu_torch" and "tracing" in (fromlist or ()):
            raise ImportError("no tracing")
        return real_import(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    result = run_traced()
    assert result["correct"], result["checks"]
    assert not set(SPAN_METRICS) & set(result["metrics"])
    for name in SPAN_METRICS:  # every file loads; each reader returns None
        assert load_metric(name).read(NS(state={}, trace=None,
                                         traced_requests=1)) is None
