"""One run of one cell: set-up, the measured window, the reference check.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``,
through the entry's ``file``) and its traffic (``traffic/<name>.json``);
each metric the benchmark lists for the cell is read by
``metrics/<name>.py``'s ``read(run)``.  A later cell, configuration or
metric is new files and new entries.

The window drives ``soap_tpu_torch.pipeline.run.build_catalogue``: each
pass catalogues one snapshot, from host arrays to the sorted,
unit-annotated catalogue in memory.  Each pass moves the universe by
whole top-level cells (``universe.pass_shift``), so no pass sees the
inputs of another; the move, the catalogue's columns and the reader's
conversion of them are done inside the window.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np
import torch

from halobench import devtrace, inputs, reference, roofline
from halobench import universe as U

#: the benchmark's folder, relative to a checkout's root
FOLDER = "halobench"
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "soap_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``soap_tpu_torch`` is not ``soap_tpu``)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, root: Path):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(
        f"halobench_metric_{name}", Path(root) / FOLDER / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_plan(bench: Mapping, workload: str, root: Path) -> Dict[str, object]:
    """The cell's entry, configuration, traffic, and the metrics it
    reports with tracing off and on."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(Path(root) / FOLDER / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(cell=cell, config=config, traffic=traffic, root=Path(root),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class Cell:
    """The program's inputs of one cell and seed, and one pass of it."""

    def __init__(self, config: Mapping, traffic: Mapping, seed: int, device, root: Path):
        from soap_tpu_torch.core.params import ParameterFile
        from soap_tpu_torch.pipeline.chunks import fields_per_type
        from soap_tpu_torch.pipeline.run import entry_plan

        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.cells = int(traffic["cells_per_side"])
        self.meta = inputs.snapshot_info(config, traffic)
        # the parameter file as the configuration froze it, not the port's copy
        pf = config["parameter_file"]
        self.params = ParameterFile(str(Path(root) / FOLDER / "configs" / pf)) if pf else None
        self.keys = frozenset(
            (Path(root) / FOLDER / "configs" / config["keys"]).read_text().split())
        self.ptypes, self.specs = entry_plan(self.meta, bool(config["dmo"]), self.params)
        # the datasets the port reads; the reference sums a few more
        wanted = fields_per_type(self.specs, self.meta, self.ptypes)
        drawn = {pt: list(names) for pt, names in wanted.items()}
        for pt, ds in reference.HYDRO_FIELDS.values():
            if config["hydro"] and ds not in drawn.setdefault(pt, []):
                drawn[pt].append(ds)
        self.uni = U.build_universe(config, traffic, seed, self.device, drawn)
        self.host = inputs.host_fields(self.uni, self.meta, wanted, self.ptypes)

    def shift(self, pass_nr: int) -> np.ndarray:
        return U.pass_shift(int(self.traffic["layout_seed"]), pass_nr, self.cells)

    def subs(self, pass_nr: int) -> Dict[str, np.ndarray]:
        centres = U.shifted(self.uni.halo_centre, self.shift(pass_nr), self.uni.boxsize,
                            self.cells)
        return inputs.hbtplus_subs(self.uni, centres)

    def run_pass(self, pass_nr: int):
        """One snapshot's catalogue through ``build_catalogue``."""
        from soap_tpu_torch.io.halo_catalogue import hbtplus_catalogue
        from soap_tpu_torch.pipeline.run import build_catalogue

        s = self.shift(pass_nr)
        host = {pt: (U.shifted(pos, s, self.uni.boxsize, self.cells), fields)
                for pt, (pos, fields) in self.host.items()}
        cat = hbtplus_catalogue(self.subs(pass_nr), self.uni.h)
        # the program's own default where the traffic leaves read-ahead unset
        extra = {"prefetch": bool(self.traffic["prefetch"])} if "prefetch" in self.traffic else {}
        out = build_catalogue(
            self.meta, cat, host, self.specs, self.params, bool(self.config["dmo"]),
            device=self.device, nr_chunks=int(self.traffic["nr_chunks"]), **extra)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return out


def keep(out, paths: List[str], a: float) -> Dict[str, object]:
    """What the judge reads of a pass: the compared datasets with the
    factor to physical values, the halo order, and every dataset's name."""
    data = {}
    for p in paths:
        ds = out.catalogue.datasets[p]
        physical = int(np.ravel(ds.attrs.get("Value stored as physical", [1]))[0])
        exp = float(np.ravel(ds.attrs.get("a-scale exponent", [0.0]))[0])
        data[p] = (np.asarray(ds.data), 1.0 if physical else a**exp)
    return {"index": np.asarray(out.catalogue.datasets["InputHalos/HaloCatalogueIndex"].data),
            "data": data, "keys": frozenset(out.catalogue.datasets)}


def evaluate(cell: Cell, kept: List[dict], sample: int, control: bool = False):
    """(the program's numbers, the control's or None): the largest gap of
    each number over a sample of (pass, halo) pairs drawn from the seed
    (the most massive halos always among them), and the rows out of the
    spatial order over every pass, and the datasets missing from the
    configuration's frozen list or not on it, over every pass."""
    cfg, ref = cell.config, cell.config["reference"]
    ref = dict(ref, boxsize=cell.uni.boxsize)
    cosmo = cfg["cosmology"]
    H = cell.uni.n_halos
    rng = np.random.default_rng([cell.seed % (1 << 63), 7])
    pairs = {(int(rng.integers(len(kept))), h) for h in range(min(4, H))}
    while len(pairs) < min(sample, len(kept) * H):
        pairs.add((int(rng.integers(len(kept))), int(rng.integers(H))))
    names = ref["numbers"]
    prog = dict.fromkeys(names, 0.0)
    ctrl = dict.fromkeys(names, 0.0) if control else None
    #: per number, the (pass, halo, bound particles) of its widest gap
    worst: Dict[str, list] = {}
    missing = 0
    for i, k in enumerate(kept):
        prog["keys_wrong"] = max(prog["keys_wrong"], len(k["keys"] ^ cell.keys))
        subs = cell.subs(k["pass"])
        want = reference.sort_order(reference.catalogue_centres(subs, cell.uni.h),
                                    cell.uni.boxsize, cell.cells)
        if len(k["index"]) != H:
            missing += H - len(k["index"])
            prog["sort_misplaced"] += H
        else:
            prog["sort_misplaced"] += int((k["index"] != want).sum())
        if control:
            c16 = torch.as_tensor(reference.catalogue_centres(subs, cell.uni.h)).to(
                torch.bfloat16).double().numpy()
            got = reference.sort_order(c16, cell.uni.boxsize, cell.cells)
            ctrl["sort_misplaced"] += int((got != want).sum())
    parts = reference.PassParticles(cell.uni, cell.device, bool(ref.get("hydro")))
    by_pass: Dict[int, List[int]] = {}
    for p, h in sorted(pairs):
        by_pass.setdefault(p, []).append(h)
    a = float(cosmo["a"])
    for p, halos in by_pass.items():
        k = kept[p]
        parts.shift(cell.shift(k["pass"]), cell.cells)
        centres = reference.catalogue_centres(cell.subs(k["pass"]), cell.uni.h)
        row = {int(h): r for r, h in enumerate(k["index"])}
        # past the halo's particles and, at the field's mean spacing, some
        # field particles: an SO's crossing can lie between them
        spacing = cell.uni.boxsize / max(len(parts.mass), 1) ** (1.0 / 3.0)
        radii = torch.as_tensor(np.maximum(3.0 * cell.uni.halo_renclose[halos],
                                           max(0.15, 1.5 * spacing)))
        near = parts.near(torch.as_tensor(centres[halos], device=cell.device),
                          radii.to(cell.device))
        for h, idx in zip(halos, near):
            if h not in row:
                missing += 1
                continue
            radius = float(radii[halos.index(h)])
            while True:
                hd = reference.halo_data(parts, h, centres[h], idx)
                # unmasked: the judge applies the category filters itself
                ref_ans = reference.answers(hd, ref, cosmo, masks=False)
                # every SO's crossing well inside the particles read
                so_r = [float(ref_ans[f"{so['group']}/SORadius"]) for so in ref["so"]]
                if 0 < min(so_r) and max(so_r) < 0.9 * radius * a:
                    break
                if radius > 0.25 * cell.uni.boxsize:
                    break
                radius *= 2.0
                idx = parts.near(torch.as_tensor(centres[h:h + 1], device=cell.device),
                                 torch.tensor([radius], device=cell.device))[0]
            got = {path: v[row[h]] * f for path, (v, f) in k["data"].items()}
            for n, g in reference.judge(got, ref_ans, hd, ref, cosmo).items():
                if g > prog[n]:
                    prog[n] = g
                    worst[n] = [int(k["pass"]), int(h), int(cell.uni.halo_nbound[h])]
            if control:
                got = reference.answers(hd, ref, cosmo, "bfloat16")
                for n, g in reference.judge(got, ref_ans, hd, ref, cosmo).items():
                    ctrl[n] = max(ctrl[n], g)
    del parts
    return prog, ctrl, missing, worst


def run_cell(plan: Mapping, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, warm: bool = True) -> dict:
    """The result line of one run (and, with ``control``, the control's
    numbers under ``control``; ``warm`` False skips the warm pass, for
    readings that time nothing)."""
    import soap_tpu_torch  # noqa: F401  (the program under test)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config, traffic = plan["config"], plan["traffic"]
    if cuda:
        from soap_tpu_torch.ops import kernel_lib

        for name in ("range_gather", "inertia_loop"):
            kernel_lib.load(name)
    cell = Cell(config, traffic, seed, dev, plan["root"])
    if warm:
        cell.run_pass(-1)  # the caching allocator, the kernels' first launches
    setup_s = time.perf_counter() - t_start

    paths = reference.answer_paths(config["reference"])
    a = float(config["cosmology"]["a"])
    kept, passes = [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tracer = devtrace.DeviceTrace() if trace and cuda else None
    if tracer:
        tracer.__enter__()
    t0 = time.perf_counter()
    k = 0
    while True:
        tp = time.perf_counter()
        out = cell.run_pass(k)
        passes.append(dict(
            halos=out.catalogue.n_halos, wall_s=time.perf_counter() - tp,
            prep_s=out.prep_seconds, stage_s=out.stage_seconds,
            engine_s=out.engine_seconds, post_s=out.post_seconds,
            bucket_calls=out.stats.n_bucket_calls))
        kept.append(dict(keep(out, paths, a), **{"pass": k}))
        del out
        k += 1
        if trace:
            if k >= int(traffic["trace_passes"]):
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if tracer:
        tracer.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    device_run, work = None, None
    if tracer:
        device_run = devtrace.summarise(tracer.events, window_s)
        del tracer
        # the traced passes again, untimed: each pass plans its own buckets
        with roofline.WorkCounter() as counter:
            for p in range(len(passes)):
                cell.run_pass(p)
        work = dict(k1_s=counter.k1_s, k2_s=counter.k2_s,
                    k1_calls=counter.k1_calls, k2_calls=counter.k2_calls)
    run = dict(halos=sum(p["halos"] for p in passes), window_s=window_s, setup_s=setup_s,
               peak_bytes=peak, passes=passes, device=device_run, work=work)
    metrics = {}
    for m in (plan["per_layer"] if trace else plan["end_to_end"]):
        value = load_metric(m["name"], plan["root"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the reference, once the window is closed and the program's state freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    prog, ctrl, missing, worst = evaluate(cell, kept, int(traffic["sample_halos"]), control)
    limits = config["limits"]
    checks = {n: {"value": float(prog[n]), "limit": float(limits[n])}
              for n in config["reference"]["numbers"]}
    correct = missing == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": len(passes) * cell.uni.n_halos,
        "failed": int(missing),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
        "passes": len(passes),
        "pass_s": [p["wall_s"] for p in passes],
        "reference_s": time.perf_counter() - t_ref,
    }
    if device_run:
        result["device"]["busy_s"] = float(device_run["busy_s"])
        result["device"]["window_s"] = float(window_s)
        result["breakdown"] = device_run["breakdown"]
    if control:
        result["control"] = {n: float(ctrl[n]) for n in ctrl}
    result["worst"] = worst
    result["checks"] = checks
    return result
