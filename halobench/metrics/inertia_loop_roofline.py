"""K2's share of its roofline: the least time its calls in the traced
passes could take (``roofline.py``: bytes, float32 and float64 operations,
iterations from the frozen plain loop; counted on those passes run again,
untimed) over its device time in them (kernels named
``inertia_loop_kernel``)."""

KERNEL = "inertia_loop_kernel"


def read(run):
    dev, work = run["device"], run["work"]
    if not dev or not work or not work["k2_calls"]:
        return None
    seconds = sum(s for name, (_, s) in dev["by_name"].items() if KERNEL in name)
    if seconds <= 0:
        return None
    return 100.0 * work["k2_s"] / seconds
