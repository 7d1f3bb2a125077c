"""Seconds from the process's start to the window's: imports, the
kernels loaded from the checkout's build, the inputs drawn and one warm
pass."""


def read(run):
    return run["setup_s"]
