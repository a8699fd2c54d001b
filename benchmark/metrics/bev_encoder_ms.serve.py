"""bev_encoder_ms.serve: ms a request between the CUDA events of the
program's span `model.head.bev_encoder` (BEVFormer's BEV encoder, its 6
layers and what they share, models/bevformer.py::BEVFormerHead.steps),
in requests sent without the profiler. Moves frames_per_s."""

from harness.spans import install as install_spans, span_ms

PROFILED = False  # timed in requests sent before the profiled ones


def install(run):
    install_spans(run, PROFILED)


def read(run):
    return span_ms(run, "model.head.bev_encoder")
