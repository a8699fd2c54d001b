"""Reading a torch.profiler trace of the traced window.

`Trace(prof)` holds the device events (kernels, copies, sets) of
one profile, the host's operator events, and the window, the host-side
range `bench::window` that the harness wraps around the traced requests.
The arithmetic is the benchmark's own:

  * busy time is the union of the device events' intervals, as
    graph_detr4d_tpu_torch/tools/profile_ops.py:94-105 computes it
    (overlapping kernels count once);
  * a device event belongs to a host range (`record_function`) when the
    runtime call that launched it (same correlation id, as
    profile_ops.py:64-83 pairs them) started inside that range;
  * an idle gap of the device is put down to the innermost operator the
    requests' thread was running at its midpoint, or to "host: between
    operators";
  * the host ranges' projections onto the device timeline (GPU user
    annotations) are not device work and are left out.
"""

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

WINDOW = "bench::window"
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        total += max(0.0, e - max(s, end))
        end = max(end, e)
    return total


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, prof):
        events = prof.events()
        # the device timeline also projects each host range onto it (a
        # GPU user annotation spanning its kernels): not device work
        self.device = [e for e in events if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.name.startswith("bench::")]
        self.host = [e for e in events if e.device_type == DeviceType.CPU]
        windows = [e for e in self.host if e.name == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} ranges")
        w = windows[0].time_range
        self.t0, self.t1 = float(w.start), float(w.end)
        self.thread = windows[0].thread  # the thread that sends requests
        self._launches = {e.id: e for e in self.host if e.name.startswith("cu")}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clipped(self, events):
        return [(max(float(e.time_range.start), self.t0),
                 min(float(e.time_range.end), self.t1)) for e in events
                if e.time_range.end > self.t0 and e.time_range.start < self.t1]

    def busy_s(self) -> float:
        return union_us(self._clipped(self.device)) / 1e6

    def device_s(self, match) -> float:
        """Summed device seconds of the events whose name `match` accepts."""
        return sum(e.time_range.elapsed_us() for e in self.device
                   if match(e.name)) / 1e6

    def in_ranges_s(self, range_name: str):
        """(device seconds of every event launched inside a host range
        `range_name`, the number of such ranges)."""
        ranges = sorted((float(e.time_range.start), float(e.time_range.end))
                        for e in self.host if e.name == range_name)
        starts = [s for s, _ in ranges]
        total = 0.0
        for e in self.device:
            launch = self._launches.get(e.id)
            if launch is None:
                continue
            t = float(launch.time_range.start)
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                total += e.time_range.elapsed_us()
        return total / 1e6, len(ranges)

    def top_device_ops(self, n=10):
        by = defaultdict(float)
        for e in self.device:
            by[e.name[:NAME_CHARS]] += e.time_range.elapsed_us() / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The device's idle time in the window by what the host's thread
        was doing at each gap's midpoint (the innermost operator, the
        host's operators being nested): [[name, seconds]], longest
        first."""
        busy = merged(self._clipped(self.device))
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = sorted((0.5 * (edges[i] + edges[i + 1]), edges[i + 1] - edges[i])
                      for i in range(0, len(edges), 2) if edges[i + 1] > edges[i])
        ops = sorted((float(e.time_range.start), float(e.time_range.end), e.name)
                     for e in self.host if e.thread == self.thread
                     and not e.name.startswith("bench::")
                     and e.time_range.end > self.t0 and e.time_range.start < self.t1)
        by = defaultdict(float)
        stack, j = [], 0
        for mid, length in gaps:
            while j < len(ops) and ops[j][0] <= mid:
                while stack and stack[-1][1] <= ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2][:NAME_CHARS] if stack else "host: between operators"
            by[name] += length / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
