"""Halos catalogued in the window's passes over the window's length (the
first pass's start to the last pass's end, every pass whole)."""


def read(run):
    if not run["passes"] or run["window_s"] <= 0:
        return None
    return run["halos"] / run["window_s"]
