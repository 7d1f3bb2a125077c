"""Build and load the hand-written CUDA kernels of ``soap_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``build/soap_tpu_torch/lib<name>.so`` beside the package, with a
plain C interface that ``ctypes`` binds.  A library is rebuilt when its
source is newer.  Nothing here runs at import time: the first launch of
a kernel builds it, and a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "soap_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-adds: each f32 operation rounds as the plain
    # PyTorch versions' separate operations do
    "-fmad=false",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: guards the module-level launch counters (``range_gather.launches``,
#: ``inertia_loop.launches`` and ``cluster_launches``,
#: ``models/halo_slice.py::k2_launches_by_config``): the worker threads
#: of a multi-device engine launch at once
COUNT_LOCK = threading.Lock()
#: seconds spent in nvcc by this process, per library
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library is newer than it."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src.name} (rc {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


class ThreadCount(threading.local):
    """One count per thread: the launches the calling thread made (``n``,
    which the engine attributes to a particle type or a family), and
    those by a kernel's launch shape (``by``)."""

    def __init__(self):
        self.n = 0
        self.by: Dict[int, int] = {}


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
