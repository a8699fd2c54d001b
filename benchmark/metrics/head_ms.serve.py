"""head_ms.serve: ms a request of the head, CUDA events by forward hooks
in requests sent without the profiler. Moves frames_per_s."""

from harness.readers import install_head, head_ms

PROFILED = False  # timed in requests sent before the profiled ones


def install(run):
    install_head(run)


def read(run):
    return head_ms(run)
