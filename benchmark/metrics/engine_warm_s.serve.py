"""engine_warm_s.serve: seconds of serve.Engine's warm-up in set-up, the
program's spans `engine.warm.infer` and `engine.warm.infer_stream`
(recorded with tracing off). Moves setup_s."""

from harness.spans import install as install_spans, warm_s

PROFILED = False  # reads what set-up recorded


def install(run):
    install_spans(run, PROFILED)


def read(run):
    return warm_s(run)
