"""Seconds per pass the host waits at the bucket results' copy to the
host (``engine.to_host`` spans)."""

from halobench import spans


def read(run):
    return spans.seconds_per_pass(run, "engine.to_host")
