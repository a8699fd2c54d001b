"""Readers of the program's own spans (graph_detr4d_tpu_torch/tracing.py).

`install(run, profiled)` turns the program's tracing on for one pass of
the traced window, however many metrics of that pass ask; its cleanup
moves the pass's records into `run.state` before it turns tracing off
(the harness runs the cleanups before the readers). The first install
also keeps what set-up left in the buffer: the spans recorded with
tracing off, the Engine's warm-up among them. A program without the
recorder, or without a span, leaves a reader nothing to read: it returns
None.

  * span_ms: the mean ms a request between a device span's CUDA events,
    in the pass without the profiler; None where the recorder's buffer
    overflowed (`dropped`), since a sum over lost records reads low;
  * idle_split: the device's idle time in the profiled window, each gap
    put down, by the midpoint rule of harness/trace.py, to the innermost
    program span around its midpoint on the requests' thread
    (`gd4d::model.backbone`, `gd4d::model.head`, else
    `gd4d::engine.request`, else outside any request); the four parts
    add up to the window less the union of the device's events;
  * warm_s: the seconds of the Engine's warm-up spans.
"""

import torch

from harness.trace import merged

PREFIX = "gd4d::"  # the program's profiler ranges (tracing.PREFIX)
REQUEST = "engine.request"
MODEL = {"model.backbone": "backbone", "model.head": "head"}
SETUP, UNPROFILED, PROFILED = "spans.setup", "spans.unprofiled", "spans.profiled"
DROPPED = "spans.dropped"


def install(run, profiled):
    on = "spans.on"
    if run.state.get(on):
        return
    try:
        from graph_detr4d_tpu_torch import tracing
    except ImportError:
        return
    if SETUP not in run.state:
        run.state[SETUP] = tracing.drain()
    tracing.enable()
    run.state[on] = True

    def off():
        run.state.setdefault(PROFILED if profiled else UNPROFILED, []).extend(
            tracing.drain())
        run.state[DROPPED] = tracing.RECORDER.dropped
        tracing.disable()
        run.state[on] = False

    run.cleanups.append(off)


def span_ms(run, name):
    """Mean ms a request between the CUDA events of span `name`, over the
    requests of the pass without the profiler."""
    records = [r for r in run.state.get(UNPROFILED, []) if r.name == name
               and getattr(r, "events", None) is not None]
    if not records or not run.traced_requests or run.state.get(DROPPED):
        return None
    torch.cuda.synchronize(run.device)
    return sum(r.device_ms() for r in records) / run.traced_requests


def gaps(trace):
    """(midpoint, length) of each idle gap of the device in the window,
    in the trace's us, in time order."""
    busy = merged(trace._clipped(trace.device))
    edges = [trace.t0] + [x for iv in busy for x in iv] + [trace.t1]
    return [(0.5 * (edges[i] + edges[i + 1]), edges[i + 1] - edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def idle_split(trace):
    """{"backbone", "head", "engine", "outside": idle seconds} of the
    window, or None where the trace holds no device event or no request
    span. A gap whose midpoint is on a span's edge is the span's."""
    spans = sorted(((float(e.time_range.start), float(e.time_range.end),
                     e.name[len(PREFIX):]) for e in trace.host
                    if e.thread == trace.thread and e.name.startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))  # an outer span first
    if not trace.device or not any(n == REQUEST for *_, n in spans):
        return None
    by = dict.fromkeys(("backbone", "head", "engine", "outside"), 0.0)
    stack, j = [], 0
    for mid, length in gaps(trace):
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        names = [n for *_, n in reversed(stack)]
        part = next((MODEL[n] for n in names if n in MODEL),
                    "engine" if REQUEST in names else "outside")
        by[part] += length / 1e6
    return by


def idle_ms(run, part):
    """Device idle ms a request in `part` of the profiled window."""
    if "spans.idle" not in run.state:
        run.state["spans.idle"] = (None if run.trace is None
                                   else idle_split(run.trace))
    split = run.state["spans.idle"]
    if split is None or not run.traced_requests:
        return None
    return 1e3 * split[part] / run.traced_requests


def warm_s(run):
    """Seconds of the Engine's warm-up spans (`engine.warm.<entry>`) in
    what set-up recorded, the last of each entry: this run's Engine."""
    last = {r.name: r for r in run.state.get(SETUP, [])
            if r.name.startswith("engine.warm.")}
    if not last:
        return None
    return sum(r.end_ns - r.start_ns for r in last.values()) / 1e9
