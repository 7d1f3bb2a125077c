#!/usr/bin/env python3
"""The benchmark of soap_tpu_torch: one run of one cell.

    python3 halobench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``halobench/`` and ``soap_tpu_torch/``, on a machine with a CUDA card.
Prints the result as one JSON object, the last line of standard output,
and each compared number beside its limit as the last lines of standard
error.  Exits 2 without a CUDA card (it never falls back to the CPU), 3
if JAX or the JAX package was loaded, 1 on any other failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from halobench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    plan = harness.cell_plan(bench, args.workload, ROOT)
    chips = int(plan["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"halobench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = harness.run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"halobench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    result["card"] = harness.card_line()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
