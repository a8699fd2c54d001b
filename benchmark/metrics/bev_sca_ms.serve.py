"""bev_sca_ms.serve: ms a request between the CUDA events of the
program's span `model.head.bev_sca` (BEVFormer's spatial cross-attention:
the gather of each camera's compacted rows, K1, the sum back and the
output projection, models/bevformer.py::SpatialCrossAttention.steps),
summed over the encoder layers, in requests sent without the profiler.
Moves frames_per_s."""

from harness.spans import install as install_spans, span_ms

PROFILED = False  # timed in requests sent before the profiled ones


def install(run):
    install_spans(run, PROFILED)


def read(run):
    return span_ms(run, "model.head.bev_sca")
