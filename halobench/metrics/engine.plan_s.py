"""Host seconds per pass in the engine's plans (``engine.plan`` spans:
the presize, the candidate counts' readback and the tile plan of each
round)."""

from halobench import spans


def read(run):
    return spans.seconds_per_pass(run, "engine.plan")
