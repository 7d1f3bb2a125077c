"""Host seconds per pass spent queuing bucket programs: the
``engine.issue`` spans (each bucket's gathers, radius sort and property
families) less the host's waits for the device inside them on the span's
own thread (its blocking CUDA runtime calls: the DAG's reads of device
values and its synchronising copies)."""

from halobench import spans


def read(run):
    return spans.seconds_per_pass(run, "engine.issue", less_waits=True)
