"""Host seconds per pass merging bucket results: copies resolved, result
buffers filled, retries chosen (``engine.resolve`` spans)."""

from halobench import spans


def read(run):
    return spans.seconds_per_pass(run, "engine.resolve")
