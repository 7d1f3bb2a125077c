"""run.py without a card: it fails and prints no result, never falling
back to the CPU; with one (marked ``card``) a short run is correct."""

import json
import os
import subprocess
import sys

import pytest

from halobench.tests.conftest import ROOT


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "halobench/run.py", "--workload", "dmo.hbt.chunk1", "--seed",
         str(2**33 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, "halobench/run.py", "--workload", "nope", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "halobench/run.py", "--workload", "dmo.hbt.chunk1", "--seed",
         str(2**33 + 12), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
