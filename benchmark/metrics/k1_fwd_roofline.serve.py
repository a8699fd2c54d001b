"""k1_fwd_roofline.serve: K1's forward share of its roofline, %:
msda_bound_ms of each call's arguments over the device time of its
kernels. Moves frames_per_s."""

from harness.readers import install_k1, k1_fwd_roofline


def install(run):
    install_k1(run)


def read(run):
    return k1_fwd_roofline(run)
