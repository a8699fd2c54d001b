"""Instruments the per-layer metrics install for the traced window, each
undone when the window closes (`run.cleanups`)."""

import importlib

import torch
from torch.profiler import record_function


def wrap_entry(run, module_name: str, attr: str, range_name: str, on_call):
    """Run every call of the program's `module_name.attr` inside a host
    range `range_name`, then hand its arguments to `on_call`. False, and
    nothing wrapped, where the program has no such entry."""
    mod = importlib.import_module(module_name)
    real = getattr(mod, attr, None)
    if real is None:
        return False

    def wrapped(*args, **kwargs):
        with record_function(range_name):
            out = real(*args, **kwargs)
        on_call(*args, **kwargs)
        return out

    setattr(mod, attr, wrapped)
    run.cleanups.append(lambda: setattr(mod, attr, real))
    return True


def time_modules(run, key: str, first, last):
    """CUDA events before `first`'s forward and after `last`'s, one pair a
    call, kept in run.state[key]."""
    pairs = run.state.setdefault(key, [])
    start = []

    def pre(module, args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        start.append(e)

    def post(module, args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        pairs.append((start.pop(), e))

    handles = [first.register_forward_pre_hook(pre),
               last.register_forward_hook(post)]
    run.cleanups.append(lambda: [h.remove() for h in handles])


def mean_ms_per_request(run, key: str):
    pairs = run.state.get(key)
    if not pairs:
        return None
    torch.cuda.synchronize(run.device)
    return sum(a.elapsed_time(b) for a, b in pairs) / run.traced_requests


class ShapeOf:
    """A tensor's shape, device and element size, without its data: what a
    bound reads of the value it is given."""

    def __init__(self, t):
        self.shape, self.device, self.dtype = t.shape, t.device, t.dtype
        self._elt = t.element_size()

    def element_size(self):
        return self._elt

    def numel(self):
        return self.shape.numel()
