"""Running a forward written as a generator of K1 calls.

A `steps` generator (every cross-attention of the camera decoder,
DecoderLayer.steps, Detr3DHeadPE.steps) yields the arguments of each K1
call it needs (ops/msda.py::msda_forward), the 5-tuple (value,
spatial_shapes, loc, attn, index or None), and is sent the call's output
back; what it returns is the forward's result. It may also yield an
eager stretch (`Eager`): a short piece of Python that has to run on
every call (a span opened or closed, a counter, a function that a
caller may wrap through its module attribute, as MP's query graph), and
is sent its result back. A generator that calls another's `yield from`
it, so the camera decoder launches K1 nowhere else. The kernel and the
eager stretches are run by whoever drives the generator, which chooses
how the code between two yields runs:

  * `run_k1`: eagerly, launching msda_ops.msda_forward at each K1 yield
    and running each eager stretch in line;
  * `K1Graphs`: as CUDA graphs, one for each stretch of the generator
    before, between and after its yields, replayed in that order with
    the K1 launches and the eager stretches run between them.

K1 is launched through the module attribute `msda_ops.msda_forward` in
both, never a reference kept from an earlier call, so its launch counter
and whatever wraps the attribute see every call.
"""

import warnings

import torch
import torch.nn as nn

from ..ops import msda as msda_ops


class Eager:
    """An eager stretch a `steps` generator yields: fn(*args), run by
    whoever drives the generator on every call, and the generator is
    sent its result. `out`: the (shape, dtype) of the tensor fn returns,
    on the inputs' device, or None where the generator uses nothing it
    returns. Under `K1Graphs` fn runs between two graphs on what the
    graphs before it left, and the graphs after it read a copy of its
    result."""

    __slots__ = ("fn", "args", "out")

    def __init__(self, fn, *args, out=None):
        self.fn, self.args, self.out = fn, args, out


def _run(step):
    """What a yield is sent back: the eager stretch's result, or K1's
    output, launched through msda_ops.msda_forward."""
    if isinstance(step, Eager):
        return step.fn(*step.args)
    return msda_ops.msda_forward(*step)


def run_k1(steps):
    """Drive a `steps` generator eagerly: K1 launched and each eager
    stretch run at its yield, the result sent back. Returns the
    generator's result."""
    try:
        step = next(steps)
        while True:
            step = steps.send(_run(step))
    except StopIteration as done:
        return done.value


class K1Module(nn.Module):
    """A module written as a `steps` generator: forward takes steps'
    arguments and runs it eagerly (`run_k1`)."""

    def forward(self, *args, **kwargs):
        return run_k1(self.steps(*args, **kwargs))


def _signature(inputs):
    """What a set of graphs is captured for: each input's shape, dtype and
    device, or None for an absent one. Not its strides: a replay copies
    the input into a contiguous tensor of the graphs' own."""
    return tuple(None if t is None else (t.shape, t.dtype, t.device)
                 for t in inputs)


class K1Graphs:
    """CUDA graphs of a `steps` generator, split at its K1 calls and its
    eager stretches, one set per input signature (each input's shape,
    dtype and device).

    A signature's first call runs eagerly (`run_k1`); its second captures
    the graphs and replays them; later calls replay. So a shape seen once
    never pays for a capture. A call that replays copies the caller's
    tensors into the graphs' own inputs (it neither keeps nor aliases
    them), replays each graph in turn with K1 launched, or the eager
    stretch run, on the arguments the graphs before it left, its output
    copied into a tensor the graphs after it read, and returns a fresh
    copy of the result dict, never the graphs' memory. Every graph of a
    signature shares one memory pool, which holds the intermediates the
    graphs pass each other.

    The capture runs neither K1 nor an eager stretch: each runs once a
    call, in the replay. The generator must make no host synchronisation
    outside its eager stretches (a capture cannot hold one) and must
    read nothing but its inputs, the module's parameters and buffers,
    and device constants: the graphs see weights loaded in place
    (`load_state_dict`), not tensors the module is given afterwards
    (`.to()` of its parameters). `captures` and `replays` count the calls
    that captured and that replayed graphs made earlier."""

    def __init__(self):
        self.captures = self.replays = 0
        self._seen = set()
        self._sets = {}

    def __call__(self, make_steps, inputs):
        """make_steps(*inputs) -> a `steps` generator whose result is a
        dict of tensors; inputs: tensors on one CUDA device, or None."""
        key = _signature(inputs)
        graphs = self._sets.get(key)
        if graphs is None and key not in self._seen:
            self._seen.add(key)
            return run_k1(make_steps(*inputs))
        device = next(t for t in inputs if t is not None).device
        with torch.cuda.device(device):
            if graphs is None:
                graphs = self._sets[key] = _Segments(make_steps, inputs,
                                                     device)
                self.captures += 1
            else:
                self.replays += 1
            return graphs.replay(inputs)


class _Segments:
    """One signature's graphs, what runs between them (`cuts`: K1's
    arguments or an eager stretch, each kept, with the graph memory it
    reads) and the tensors the graphs after a cut read its output from
    (`outs`, None where they read none)."""

    def __init__(self, make_steps, inputs, device):
        # normal tensors, not inference tensors: a replay may then write
        # them under inference mode and outside it alike
        with (torch.inference_mode(False), torch.no_grad(),
              warnings.catch_warnings()):
            # a generator that opens with an eager stretch (BEVFormer's
            # span) captures an empty first graph, which replays as nothing
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            self.inputs = [None if t is None else
                           torch.empty(t.shape, dtype=t.dtype, device=t.device)
                           for t in inputs]
            self.graphs, self.cuts, self.outs = [], [], []
            steps = make_steps(*self.inputs)
            pool = torch.cuda.graph_pool_handle()
            sent = None
            while True:
                graph = torch.cuda.CUDAGraph()
                # thread_local: another thread's host-to-device copy (an
                # HTTP thread's request) does not break the capture
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    try:
                        step = steps.send(sent)
                    except StopIteration as done:
                        step, self.result = None, done.value
                self.graphs.append(graph)
                if step is None:
                    break
                sent = _output(step, device)
                self.cuts.append(step)
                self.outs.append(sent)

    def replay(self, inputs):
        for static, t in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(t)
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.cuts):
                out = _run(self.cuts[i])
                if self.outs[i] is not None:
                    self.outs[i].copy_(out)
        return {k: v.clone() for k, v in self.result.items()}


def _output(step, device):
    """The tensor the graphs after a yield read its result from: K1's
    output, an eager stretch's declared `out`, or None."""
    if isinstance(step, Eager):
        if step.out is None:
            return None
        shape, dtype = step.out
        return torch.empty(shape, dtype=dtype, device=device)
    value, _, loc, _, index = step
    rows = loc.shape[1] if index is None else index.shape[1]
    return torch.empty(value.shape[0], rows, value.shape[2] * value.shape[3],
                       dtype=value.dtype, device=value.device)
