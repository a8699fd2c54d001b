"""device_idle.serve: the share of the profiled requests' span in which no
device operation ran, %. Moves frames_per_s."""

from harness.readers import device_idle


def read(run):
    return device_idle(run)
