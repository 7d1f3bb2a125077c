"""Shared pieces of the benchmark's own tests (run with
``python -m pytest halobench/tests`` from the repository's root)."""

import json
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

#: a universe small enough for the CPU: a 16 cMpc box of particles of
#: 1e10 Msun, 23 halos of 32-1900 particles and 11,525 field particles
TINY = dict(boxsize=16.0, sample_halos=64)
TINY_CONFIG = dict(particle_mass=1.0)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_plan(workload: str, **traffic):
    from halobench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    plan = harness.cell_plan(bench, workload, ROOT)
    plan["traffic"] = dict(plan["traffic"], **dict(TINY, **traffic))
    plan["config"] = dict(plan["config"], **TINY_CONFIG)
    return plan


def run_tiny(workload: str, seed: int = 2**33 + 3, seconds: float = 0.0, trace: bool = False,
             control: bool = False, **traffic):
    from halobench import harness

    return harness.run_cell(tiny_plan(workload, **traffic), seed, seconds, trace, "cpu",
                            time.perf_counter(), control=control)
