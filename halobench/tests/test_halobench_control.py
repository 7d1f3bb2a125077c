"""The control, the reference computed in bfloat16 (the precision below
the configurations' float32) in the program's place, comes out not
correct, where the program comes out correct: at the tiny size here,
and at the cells' own size on the card by ``halobench/control.py``."""

import pytest

from halobench.tests.conftest import run_tiny


@pytest.mark.parametrize("workload", ["dmo.hbt.chunk1", "flamingo.hbt.chunk1"])
def test_control_fails_a_limit(workload):
    result = run_tiny(workload, control=True, boxsize=14.0)
    checks = result["checks"]
    assert result["correct"], checks
    over = [n for n, v in result["control"].items() if v > checks[n]["limit"]]
    assert over, (result["control"], checks)
