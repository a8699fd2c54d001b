"""head_idle_ms.serve: device idle ms a request whose gap midpoint falls
inside the program's range `gd4d::model.head`, in the profiled requests.
Moves frames_per_s."""

from harness.spans import idle_ms, install as install_spans

PROFILED = True


def install(run):
    install_spans(run, PROFILED)


def read(run):
    return idle_ms(run, "head")
