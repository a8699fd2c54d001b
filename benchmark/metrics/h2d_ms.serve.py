"""h2d_ms.serve: the device ms a request of the host-to-device copies,
from the profile. Moves frames_per_s."""

from harness.readers import h2d_ms


def read(run):
    return h2d_ms(run)
