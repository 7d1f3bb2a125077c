#!/usr/bin/env python3
"""Main-path throughput of two or more source trees on one GPU, in turns.

    python3 ab_paths.py ROOT [ROOT ...] [--passes N] [--path main|hydro]

Each ROOT is a checkout (or an unpacked ``git archive``) that holds
``soap_tpu_torch/`` and ``chip_smoke.py``.  For each ROOT in the order
given, a fresh process imports both from that ROOT, stages
``chip_smoke.BENCH``'s universe (bench.py::bench_dmo's) with that tree's
``chip_smoke._bench_inputs`` (its spec list and arguments), runs two warm
passes and N timed passes (default 7), and prints one JSON line: the
root, the card, each pass's halos/s, their median and the peak device
memory.  ``--path hydro`` runs ``chip_smoke.HYDRO``'s universe (the
hydro path: bench.py::bench_hydro's at 2048 halos) with that tree's
``chip_smoke._hydro_inputs`` and the default hydro list instead.  To
compare two trees, give them as parent, change, change, parent.  Exits
1 without a CUDA device.
"""

import json
import subprocess
import sys
import time


def child(root: str, passes: int, path: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from soap_tpu_torch.pipeline.engine import HaloEngine
    from soap_tpu_torch.utils.mock_data import build_mock_universe

    dev = torch.device("cuda", 0)
    if path == "hydro":
        uni = build_mock_universe(**cs.HYDRO)
        ctx, chunk, args, specs = cs._hydro_inputs(uni, dev)
    else:
        uni = build_mock_universe(**cs.BENCH)
        ctx, chunk, args, specs = cs._bench_inputs(uni, dev)
    for _ in range(2):
        HaloEngine(ctx, chunk, specs, dev).process(**args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(passes):
        engine = HaloEngine(ctx, chunk, specs, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.process(**args)
        torch.cuda.synchronize()
        rates.append(uni.n_halos / (time.perf_counter() - t0))
    print(json.dumps({
        "root": root, "path": path, "card": torch.cuda.get_device_name(0),
        "keys": sum(len(s.keys) for s in specs),
        "halos_per_s": [round(r, 2) for r in rates],
        "median": round(float(np.median(rates)), 2),
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
    }), flush=True)


def main() -> int:
    argv = sys.argv[1:]
    if argv[:1] == ["--child"]:
        child(argv[1], int(argv[2]), argv[3])
        return 0
    passes = 7
    if "--passes" in argv:
        i = argv.index("--passes")
        passes = int(argv[i + 1])
        del argv[i : i + 2]
    path = "main"
    if "--path" in argv:
        i = argv.index("--path")
        path = argv[i + 1]
        del argv[i : i + 2]
    import torch

    if not torch.cuda.is_available() or not argv:
        print("ab_paths: needs a CUDA device and at least one ROOT", file=sys.stderr)
        return 1
    for root in argv:
        subprocess.run(
            [sys.executable, __file__, "--child", root, str(passes), path], check=True
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
