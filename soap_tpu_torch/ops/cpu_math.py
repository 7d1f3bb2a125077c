"""Initialise the CPU's vector math library before any threaded call.

PyTorch's CPU builds route the elementwise transcendental functions
(``sqrt``, ``exp``, ``log``, ``log10``, ``sin`` ... on contiguous float
tensors) to Intel MKL's vector math functions, one call per chunk of
2048 elements, from every OpenMP thread of the intra-op pool at once.
The first such call of a process is not reliable when it is threaded:
in about one fresh process in twenty (torch 2.13.0+cpu, MKL 2024.2, 8
threads), one thread's chunk comes back at ~11-bit accuracy (relative
error up to 3e-4), and every later call of any of the functions, from
any thread, is exact.  A first call that runs on one thread never went
wrong, and neither did the threaded calls after it
(``tests/test_torch_cpu_math.py``).

In the engine this showed as a CPU run whose first bucket's radii were
off by up to 3e-4 for one halo, which moved its radius sort, SO radius
and half-mass radius: the intermittent slice-test failure.  Importing
``soap_tpu_torch`` calls ``prime``, so every op of the port (host steps
and op-level tests included) comes after it; the CPU engine calls it
again (a no-op) before its first bucket.  CUDA tensors never take this
path.
"""

from __future__ import annotations

import torch

#: fewer elements than one 2048-element chunk: the call runs on one thread
_N = 1024

_primed = False


def prime() -> None:
    """Make this process's first vector math call on one thread (once;
    the results are discarded)."""
    global _primed
    if _primed:
        return
    x = torch.linspace(0.5, 2.0, _N)
    for fn in (torch.sqrt, torch.exp, torch.log, torch.log10):
        fn(x)
    _primed = True
