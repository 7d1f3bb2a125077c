"""Percent of the ``engine.process`` spans' time in which nothing ran on
the card (the union of its kernel, copy and memset intervals)."""

from halobench import spans


def read(run):
    return spans.idle_in_engine_pct(run)
