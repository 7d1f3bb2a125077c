"""A run with the timed path broken underneath comes out not correct.

Each case drives the whole of a run on the CPU (the harness's look for a
card skipped) with one fault planted in the program, at the tiny size:

- ``stale``: a pass returns the catalogue of the pass before it (a step
  that returns its state unchanged);
- ``half``: the engine computes every other halo and gives the rest the
  mean of those it computed (half of the batch left out);
- ``altered``: one halo's particle sums altered by 1e-3 where the
  property DAG produces them (an answer altered where it is produced);
- ``trimmed``: the program's property list one halo type short (a list
  trimmed to make the pass lighter).

The exchange between cards does not exist in a one-card cell."""

import numpy as np
import pytest

from halobench.tests.conftest import run_tiny


def _stale(monkeypatch):
    from soap_tpu_torch.pipeline import run

    real, memo = run.build_catalogue, []

    def stale(*a, **kw):
        out = real(*a, **kw)
        memo.append(out)
        return memo[0]

    monkeypatch.setattr(run, "build_catalogue", stale)


def _half(monkeypatch):
    from soap_tpu_torch.pipeline.engine import HaloEngine

    real = HaloEngine.process

    def half(self, centres, search_radius_phys, index, is_central, fof_id, *a, **kw):
        keep = np.arange(len(index)) % 2 == 0
        part = real(self, np.asarray(centres)[keep], np.asarray(search_radius_phys)[keep],
                    np.asarray(index)[keep], np.asarray(is_central)[keep],
                    np.asarray(fof_id)[keep], *[x[keep] if x is not None else None for x in a],
                    **kw)
        out = {}
        for g, d in part.items():
            out[g] = {}
            for k, v in d.items():
                full = np.empty((len(index),) + v.shape[1:], v.dtype)
                full[keep] = v
                full[~keep] = v.mean(0).astype(v.dtype) if len(v) else 0
                out[g][k] = full
        return out

    monkeypatch.setattr(HaloEngine, "process", half)


def _altered(monkeypatch):
    from soap_tpu_torch.ops import reductions

    real = reductions.particle_sum

    def altered(x, dim=1):
        out = real(x, dim)
        if out.dtype.is_floating_point and out.dim() >= 1 and out.shape[0] > 0:
            out = out.clone()
            out[0] = out[0] * (1.0 + 1e-3)
        return out

    monkeypatch.setattr(reductions, "particle_sum", altered)


def _trimmed(monkeypatch):
    from soap_tpu_torch.pipeline import run

    real = run.entry_plan

    def trimmed(*a, **kw):
        ptypes, specs = real(*a, **kw)
        return ptypes, specs[:-1]

    monkeypatch.setattr(run, "entry_plan", trimmed)


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "trimmed"])
@pytest.mark.parametrize("workload", ["dmo.hbt.chunk1", "flamingo.hbt.chunk1"])
def test_fault_is_not_correct(monkeypatch, fault, workload):
    {"stale": _stale, "half": _half, "altered": _altered, "trimmed": _trimmed}[fault](monkeypatch)
    result = run_tiny(workload, seconds=0.0, boxsize=12.0)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", ["dmo.hbt.chunk1", "flamingo.hbt.chunk1"])
def test_sound_run_is_correct(workload):
    result = run_tiny(workload, seconds=0.0, boxsize=12.0)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks" and result["failed"] == 0
