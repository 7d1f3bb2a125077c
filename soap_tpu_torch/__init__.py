"""soap_tpu_torch: the halo-property engine in PyTorch, with CUDA kernels.

A port of ``soap_tpu`` (JAX on a TPU) to PyTorch on NVIDIA Hopper.  The
JAX package stays the reference; this package imports neither it nor
JAX nor h5py.  Tensors live on a device the caller passes in; on CUDA
tensors the range gather and the inertia loop run hand-written kernels
(``soap_tpu_torch/csrc``), on CPU tensors their plain PyTorch versions.

Importing the package primes the CPU's vector math library
(``ops/cpu_math.py``), so no op of the port, engine or not, makes the
process's first threaded call of it.
"""

import numpy as _np

# Same numpy error rules as the reference package: host-side overflow,
# invalid and divide errors raise instead of warning.
_np.seterr(divide="raise", over="raise", invalid="raise")

__version__ = "0.1.0"

from soap_tpu_torch.ops import cpu_math as _cpu_math  # noqa: E402

_cpu_math.prime()
