"""service_ms_p95.serve: the 95th percentile of the measured window's
request times, ms (sent to answered): the tail a car waits on when the
engine is free. Moves frames_per_s."""

from harness.readers import service_ms_p95


def read(run):
    return service_ms_p95(run)
