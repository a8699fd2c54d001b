"""Spans of the serving path: the port's one span recorder.

    from graph_detr4d_tpu_torch import tracing
    tracing.enable()
    engine.infer_stream(frame, lidar2img, stream="car-7")
    records = tracing.drain()          # [Span], in the order they ended
    tracing.disable()

`span(name)` is a context manager put at a layer boundary. Off (the
default), it returns one shared no-op object: nothing is allocated, no
CUDA event is made and `torch.profiler.record_function` is not called,
which costs about 14 us a span even with no profiler running. On, it
records the name and the host's start and end in `time.time_ns()`,
around all of the span's own work (its profiler range and CUDA events):
the Unix clock onto which the profiler's host events convert
(`kineto_results.trace_start_ns() + event.time_range.start * 1000`).
While a profiler runs, the span is also a host range `gd4d::<name>` of
its trace, so it sits in the same timeline as the kernels, nested as the
spans are. A span made with `device=True` records a pair of CUDA events
around its work on the current stream (where CUDA is initialised). A
span made with `always=True` is recorded whether tracing is on or not:
one-off work (the Engine's warm-up), never a request's.

Records go to a bounded buffer; past `capacity` they are counted in
`dropped` and not kept (a reader of a pass's records refuses a pass
that overflowed). `enable()` and `disable()` are the only switch.

The spans and what reads them (benchmark/harness/spans.py):

  engine.request          serve.Engine.infer / infer_stream, one a
                          request; device idle inside it and outside
                          both model spans: engine_idle_ms
  model.backbone          GraphDETR4D.extract_feats (device);
                          backbone_span_ms, backbone_idle_ms
  model.head              GraphDETR4D.forward_feats (device);
                          head_span_ms, head_idle_ms
  engine.warm.infer, engine.warm.infer_stream
                          Engine.__init__'s warm-up (always);
                          engine_warm_s
"""

import threading
import time

import torch

PREFIX = "gd4d::"  # the profiler range of span `name` is PREFIX + name
CAPACITY = 1 << 16


class Span:
    """One recorded span: `name`, `start_ns` and `end_ns`
    (time.time_ns()), `events` (the CUDA start and end events of a
    device span, else None)."""

    __slots__ = ("name", "start_ns", "end_ns", "events", "_range",
                 "_recorder")

    def device_ms(self):
        """ms between the span's CUDA events (synchronise first); None
        without events."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._recorder._close(self)
        return False


class _NoSpan:
    """What a span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class Recorder:
    """The spans of a process (tracing's module functions use one) and
    their bounded buffer."""

    def __init__(self, capacity=CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self.dropped = 0
        self._records = []
        self._lock = threading.Lock()

    def span(self, name, device=False, always=False):
        if not (self.enabled or always):
            return NOOP
        s = Span()
        s.name, s._recorder, s._range = name, self, None
        s.start_ns = time.time_ns()
        if torch._C._autograd._profiler_enabled():
            s._range = torch.profiler.record_function(PREFIX + name)
            s._range.__enter__()
        s.events = None
        if device and torch.cuda.is_initialized():
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        return s

    def _close(self, s):
        if s.events is not None:
            s.events[1].record()
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None
        s.end_ns = time.time_ns()
        with self._lock:
            if len(self._records) < self.capacity:
                self._records.append(s)
            else:
                self.dropped += 1

    def drain(self):
        """The records kept so far, in the order they ended; the buffer
        is emptied."""
        with self._lock:
            out, self._records = self._records, []
        return out


RECORDER = Recorder()
span = RECORDER.span  # see the module's docstring
drain = RECORDER.drain


def enable():
    # a process's first profiler range costs about a millisecond (the
    # operator's first call): paid here, not inside the first span's range
    with torch.profiler.record_function(PREFIX + "enable"):
        pass
    RECORDER.enabled = True


def disable():
    RECORDER.enabled = False
