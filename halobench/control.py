#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card.

    python3 halobench/control.py --workload <name> --seeds 1,2,3 [--seconds 0]

For each seed, in one process: the cell's inputs, a window of whole
passes of the program (at least one), then the reference on a sample of
what the window produced; each number compared is read twice, for the
program (the lower reading) and for the control, the reference computed
in bfloat16 in the program's place (the upper reading).  One JSON line
per seed.  The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch

    from halobench import harness

    if not torch.cuda.is_available():
        print("halobench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    plan = harness.cell_plan(harness.load_json(ROOT / "BENCHMARK.json"), args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(plan, seed, args.seconds, False, "cuda", t0, control=True,
                             warm=False)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "correct": r["correct"],
            "passes": r["passes"], "seconds": time.perf_counter() - t0,
            "reference_s": r["reference_s"],
            "program": {n: c["value"] for n, c in r["checks"].items()},
            "control": r["control"], "worst": r["worst"],
            "limits": {n: c["limit"] for n, c in r["checks"].items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
