"""k2_fwd_roofline.serve: K2's forward share of its roofline, %:
dcn_bound_ms of each call's arguments over the device time of its
kernels. Moves frames_per_s."""

from harness.readers import install_k2, k2_fwd_roofline


def install(run):
    install_k2(run)


def read(run):
    return k2_fwd_roofline(run)
