"""mp_graph_ms.serve: ms a request between the CUDA events of the
program's span `model.head.graph` (the MP query graph of each decoder
layer, models/transformer.py::DecoderLayer.steps), summed over the
layers, in requests sent without the profiler. Moves frames_per_s."""

from harness.spans import install as install_spans, span_ms

PROFILED = False  # timed in requests sent before the profiled ones


def install(run):
    install_spans(run, PROFILED)


def read(run):
    return span_ms(run, "model.head.graph")
