"""Importing the port, and the CPU engine, prime the vector math library.

The first multi-threaded call of an MKL-backed elementwise function
(``torch.exp``, ``torch.sqrt`` ...) in a fresh process sometimes returns
one thread's chunk at ~11-bit accuracy; every later call is exact
(``soap_tpu_torch/ops/cpu_math.py``).  Without priming, that first call
came back inexact in about one fresh 8-thread process in twenty, so the
check below runs many fresh processes (one chance each); after priming
none has.  ``import soap_tpu_torch`` primes, so an op of the port called
with no engine built (a host step, an op-level test) is exact too.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.ops import cpu_math
from soap_tpu_torch.pipeline.chunk_data import ChunkData
from soap_tpu_torch.pipeline.engine import HaloEngine

ROOT = Path(__file__).resolve().parents[1]
N_PROCESSES = 60

#: a fresh process: prime as the engine does, then the first threaded
#: call, held to float64 numpy at 1e-6 (MKL's high-accuracy mode is
#: within one ulp, 1.2e-7)
_CHILD = """
import numpy as np, torch
torch.set_num_threads(8)
from soap_tpu_torch.ops import cpu_math
cpu_math.prime()
x = torch.linspace(0.001, 0.2, 1 << 21)
got = torch.exp(x).numpy().astype(np.float64)
ref = np.exp(x.numpy().astype(np.float64))
print(float(np.max(np.abs(got - ref) / ref)))
"""


#: a fresh process: import a port op (the import primes) and make the
#: first threaded vector-math call through it, cylindrical_velocities'
#: cos and sin over (4, 2^18) float32 rows (positions off the axis), with
#: no engine built; held to the same op in float64 (every later call is
#: exact) at 1e-5 of the largest velocity (exact calls reach 2.8e-7)
_CHILD_PORT_OP = """
import numpy as np, torch
torch.set_num_threads(8)
from soap_tpu_torch.ops import kinematics
rng = np.random.default_rng(5)
pos, vel = (torch.from_numpy(rng.uniform(0.5, 2.0, (4, 1 << 18, 3)).astype(np.float32))
            for _ in range(2))
L = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
got = kinematics.cylindrical_velocities(pos, vel, L).numpy().astype(np.float64)
ref = kinematics.cylindrical_velocities(pos.double(), vel.double(), L.double()).numpy()
print(float(np.abs(got - ref).max() / np.abs(ref).max()))
"""


def _child(_, code=_CHILD):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return float(out.stdout.split()[-1])


def test_first_threaded_math_call_after_prime_is_exact():
    with ThreadPoolExecutor(6) as pool:
        worst = list(pool.map(_child, range(N_PROCESSES)))
    bad = [w for w in worst if w > 1e-6]
    assert not bad, f"{len(bad)} of {N_PROCESSES} fresh processes inexact: {bad}"


def test_first_threaded_call_of_a_port_op_is_exact_without_an_engine():
    n = 40  # at the unprimed rate of ~1 in 20, 87% of 40-process runs catch it
    with ThreadPoolExecutor(6) as pool:
        worst = list(pool.map(lambda i: _child(i, _CHILD_PORT_OP), range(n)))
    bad = [w for w in worst if w > 1e-5]
    assert not bad, f"{len(bad)} of {n} fresh processes inexact: {bad}"


def test_prime_is_exact_and_idempotent():
    cpu_math.prime()
    cpu_math.prime()
    x = torch.linspace(0.5, 2.0, 4096)
    np.testing.assert_allclose(torch.exp(x).numpy(), np.exp(x.numpy().astype(np.float64)),
                               rtol=1e-6)


def test_cpu_engine_primes_before_any_bucket(monkeypatch):
    calls = []
    monkeypatch.setattr(cpu_math, "prime", lambda: calls.append(1))
    ctx = HaloContext(a=1.0, z=0.0, G=1.0, boxsize=1.0, critical_density=1.0,
                      mean_density=1.0)
    HaloEngine(ctx, ChunkData(boxsize=1.0, ptypes={}), [], "cpu")
    assert calls == [1]
