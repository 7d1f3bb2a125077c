"""Percent of the traced window in which nothing ran on the card: 100
minus the union of its kernel, copy and memset intervals over the
window's length."""


def read(run):
    dev = run["device"]
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
