"""mfu.serve: the whole request's share of the dense bfloat16 peak, %,
over the seconds the measured window's requests were served. Moves
frames_per_s."""

from harness.readers import mfu


def read(run):
    return mfu(run)
