"""backbone_ms.serve: ms a request from the start of the backbone to the
end of the neck, CUDA events by forward hooks in requests sent without
the profiler. Moves frames_per_s."""

from harness.readers import install_backbone, backbone_ms

PROFILED = False  # timed in requests sent before the profiled ones


def install(run):
    install_backbone(run)


def read(run):
    return backbone_ms(run)
