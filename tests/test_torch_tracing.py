"""The port's span recorder (graph_detr4d_tpu_torch/tracing.py) and the
serving path's counters, on the CPU at tiny size (tiny_test_config: 6
cameras = 3 of the current frame + 3 of the previous, 64x128):

  * off, a span is the shared no-op object, nothing is recorded, and a
    request makes no record_function call and no CUDA event;
  * on, an Engine call is one `engine.request` record with its copy's
    span (`engine.h2d`) and its model spans inside it;
  * under a CPU torch.profiler each span is a `gd4d::` host range whose
    start, on the Unix clock, is within 1 ms of the record's;
  * the warm-up's spans are recorded with tracing off;
  * past its capacity the buffer counts `dropped`;
  * the stream cache's hits, misses and evictions are exact.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graph_detr4d_tpu_torch import tracing
from graph_detr4d_tpu_torch.config import tiny_test_config
from graph_detr4d_tpu_torch.models.detector import GraphDETR4D
from graph_detr4d_tpu_torch.serve import Engine

REQUEST_SPANS = ["engine.h2d", "model.backbone", "model.head",
                 "engine.request"]


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    cfg = tiny_test_config()
    sd = GraphDETR4D(cfg, device="cpu").state_dict()
    tracing.drain()
    return Engine(cfg, sd, device="cpu", max_streams=2)


@pytest.fixture
def traced():
    """Tracing on for one test, the buffer empty before and after."""
    tracing.drain()
    tracing.enable()
    yield
    tracing.disable()
    tracing.drain()


def request(engine, seed=0):
    h = engine.cfg.head
    H, W = engine.cfg.img_size
    rng = np.random.default_rng(seed)
    frame = rng.normal(0, 0.5, (1, h.num_frame_cams, H, W, 3)).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, h.num_cams, 1, 1))
    return frame, l2i


def test_off_is_the_shared_noop_and_records_nothing(engine, monkeypatch):
    assert not tracing.RECORDER.enabled
    assert tracing.span("a") is tracing.span("b", device=True) is tracing.NOOP
    tracing.drain()
    made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    frame, l2i = request(engine)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.infer_stream(frame, l2i, stream="off")
    assert made == []
    assert tracing.drain() == []
    assert not [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]


def test_on_records_one_request_span_around_its_model_spans(engine, traced):
    frame, l2i = request(engine)
    for _ in range(2):
        engine.infer_stream(frame, l2i, stream="on")
    engine.infer(np.concatenate([frame, frame], axis=1), l2i)
    records = tracing.drain()
    # in the order they ended: each call's copy and model spans, then
    # its request
    assert [r.name for r in records] == 3 * REQUEST_SPANS
    for i in range(0, len(records), 4):
        h2d, backbone, head, root = records[i:i + 4]
        assert (root.start_ns <= h2d.start_ns <= h2d.end_ns
                <= backbone.start_ns <= backbone.end_ns
                <= head.start_ns <= head.end_ns <= root.end_ns)
    for a, b in zip(records[3::4], records[7::4]):  # requests do not overlap
        assert a.end_ns <= b.start_ns
    # no CUDA here: a device span has no events
    assert all(r.events is None and r.device_ms() is None for r in records)


def test_device_span_records_a_pair_of_cuda_events(monkeypatch, traced):
    class Event:
        def __init__(self, enable_timing):
            self.recorded = 0

        def record(self):
            self.recorded += 1

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with tracing.span("dev", device=True):
        with tracing.span("host"):
            pass
    host, dev = tracing.drain()
    assert host.events is None
    assert [e.recorded for e in dev.events] == [1, 1]


def test_spans_are_profiler_ranges_on_the_unix_clock(engine, traced):
    frame, l2i = request(engine)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.infer_stream(frame, l2i, stream="prof")
    records = tracing.drain()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            ranges.setdefault(e.name[len(tracing.PREFIX):], []).append(
                t0 + e.time_range.start * 1000)
    assert [r.name for r in records] == REQUEST_SPANS
    assert sorted(ranges) == sorted(REQUEST_SPANS)
    for r in records:
        assert min(abs(s - r.start_ns) for s in ranges[r.name]) < 1e6, r.name
    assert sum(map(len, ranges.values())) == len(records)


def test_warm_up_spans_are_recorded_with_tracing_off(engine):
    tracing.drain()
    Engine(engine.cfg, engine.model.state_dict(), device="cpu")
    records = tracing.drain()
    assert [r.name for r in records] == ["engine.warm.infer",
                                         "engine.warm.infer_stream"]
    assert all(r.end_ns > r.start_ns for r in records)


def test_overflow_counts_dropped():
    rec = tracing.Recorder(capacity=3)
    rec.enabled = True
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert rec.dropped == 2
    assert [r.name for r in rec.drain()] == ["s0", "s1", "s2"]
    assert rec.drain() == []


def test_stream_counters_are_exact(engine):
    """max_streams 2: scenes a and b of 5 frames, a reset, then a third
    stream c that evicts b, and b back, which evicts a."""
    frame, l2i = request(engine)
    for s in list(engine._streams):  # the earlier tests' streams
        engine.reset_stream(s)
    before = engine.counters()
    for s in ("a", "b"):
        for _ in range(5):  # a miss, then 4 hits
            engine.infer_stream(frame, l2i, stream=s)
    assert engine.reset_stream("a")
    for s in ("a", "c", "b"):  # a after its reset; c evicts b; b evicts a
        engine.infer_stream(frame, l2i, stream=s)
    after = engine.counters()
    delta = {k: after[k] - before[k] for k in
             ("served", "stream_hits", "stream_misses", "stream_evictions")}
    assert delta == {"served": 13, "stream_hits": 8, "stream_misses": 5,
                     "stream_evictions": 2}
    assert after["streams"] == 2 and list(engine._streams) == ["c", "b"]
    # the kernels' launch counters and the builds sit beside them
    assert {"msda.launches", "deform_conv.forward_launches", "builds",
            "build_s"} <= set(after)
    # the head's CUDA graphs: none on the CPU
    assert (after["head_graph_captures"], after["head_graph_replays"]) == (
        0, 0)
