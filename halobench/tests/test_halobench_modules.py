"""What a run may load: the JAX check compares top-level names whole,
and the reference loads nothing of the port."""

import ast
import subprocess
import sys

from halobench import harness
from halobench.tests.conftest import ROOT


def test_forbidden_names_compared_whole(monkeypatch):
    for name in ("soap_tpu_torch", "soap_tpu_torch.ops", "jaxtyping", "flaxen", "soap_tpu_x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [] or all(
        n.split(".")[0] in harness.FORBIDDEN for n in harness.forbidden_modules())
    assert not any(n.startswith(("soap_tpu_torch", "jaxtyping", "flaxen", "soap_tpu_x"))
                   for n in harness.forbidden_modules())
    for name in ("soap_tpu", "soap_tpu.ops.grid", "jax", "jaxlib.xla_client", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"soap_tpu", "soap_tpu.ops.grid", "jax", "jaxlib.xla_client",
            "flax.linen"} <= set(harness.forbidden_modules())


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_port():
    for f in ("reference.py", "universe.py", "k2_plain.py", "devtrace.py"):
        for name in _imports(ROOT / "halobench" / f):
            assert name.split(".")[0] not in ("soap_tpu", "soap_tpu_torch", "jax", "jaxlib"), (
                f, name)


def test_reference_loads_no_port_module_in_a_fresh_process():
    code = ("import sys; import halobench.reference, halobench.universe; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'soap_tpu', 'soap_tpu_torch', 'jax', 'jaxlib', 'flax'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_benchmark_run_loads_no_jax(tmp_path):
    """The harness and the port on the CPU, in a process of their own."""
    code = ("import sys, time; from halobench.tests.conftest import run_tiny; "
            "r = run_tiny('dmo.hbt.chunk1', boxsize=10.0); "
            "from halobench import harness; print(harness.forbidden_modules(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
