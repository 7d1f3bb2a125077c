#!/usr/bin/env python3
"""Smoke run of soap_tpu_torch on one NVIDIA GPU: build, check, drive.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one line and raising on failure:
 1. device: nvidia-smi's name and power limit, torch and CUDA versions;
 2. build: both CUDA kernels from soap_tpu_torch/csrc into
    build/soap_tpu_torch;
 3. K1 (range gather) against its plain version on a 10.5M x 16 store;
 4. K2 (inertia loop) against its plain version, at the main-path cell
    (B=256, K=32768, C=2) and at one giant halo (K=2^20);
 5. the engine on the GPU against the engine on the CPU, on a 64-halo mock
    with satellites and halos forced round the retry ladder;
 6. the main path at the bench DMO scale (2048 halos, 9.62M particles):
    a warm pass, then a timed pass with every launch counter reset.
It then prints the kernels' JSON line, the card's nvidia-smi line, and
last a JSON object with "ok": true.  Without a CUDA device it exits 1
before printing any result.  Imports torch, numpy and soap_tpu_torch
only.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.ops import inertia_loop as il
from soap_tpu_torch.ops import kernel_lib
from soap_tpu_torch.ops import range_gather as rg
from soap_tpu_torch.ops.inertia import pack_inertia_inputs
from soap_tpu_torch.pipeline.chunk_data import ChunkData, stage_ptype
from soap_tpu_torch.pipeline.engine import HaloEngine
from soap_tpu_torch.pipeline.specs import slice_specs
from soap_tpu_torch.utils.mock_data import G_INTERNAL as G
from soap_tpu_torch.utils.mock_data import build_mock_universe

K2_RTOL = 2e-5  # kernel vs plain loop: tensors, plus atol 1e-7 max|ref|
ENGINE_SEED = 11
BENCH = dict(
    n_halos=2048, n_field=400000, boxsize=170.0, seed=20260816,
    mass_range=(3.2, 3000.0),
)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


# ---------------------------------------------------------------- phases


def phase_build():
    t0 = time.perf_counter()
    for name in ("range_gather", "inertia_loop"):
        kernel_lib.build(name)
        kernel_lib.load(name)
    say("build", f"range_gather + inertia_loop into {kernel_lib.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {kernel_lib.BUILD_SECONDS})")


def phase_k1(dev):
    rng = np.random.default_rng(1)
    N, F, B, cap, S, n_ranges = 10_500_000, 16, 1024, 8192, 64, 32
    packed = torch.from_numpy(rng.random((N, F), dtype=np.float32)).to(dev)
    counts = rng.integers(0, 160, (B, n_ranges)).astype(np.int32)
    starts = np.sort(rng.integers(0, N - 200, (B, n_ranges)), 1).astype(np.int32)
    table, _, _ = rg.build_block_table(
        torch.from_numpy(starts).to(dev), torch.from_numpy(counts).to(dev),
        S, F, cap // S,
    )
    got = rg.range_gather_blocks(packed, table, S, cap)
    ref = rg.range_gather_blocks_plain(packed, table, S, cap)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K1 differs from its plain version")
    err = (got - ref).abs().max().item()
    del got, ref
    ms = time_ms(lambda: rg.range_gather_blocks(packed, table, S, cap))
    plain_ms = time_ms(lambda: rg.range_gather_blocks_plain(packed, table, S, cap))
    gbs = 2 * B * cap * F * 4 / (ms * 1e-3) / 1e9
    say("K1", f"B={B} capacity={cap} F={F} store={N}x{F}: torch.equal ok "
        f"(max abs err {err:.3e}); kernel {ms:.4f} ms ({gbs:.0f} GB/s moved), "
        f"plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _cloud(rng, B, K):
    """Radius-sorted triaxial clouds, selections and sphere radii."""
    pos = (rng.normal(size=(B, K, 3)) * [1.5, 1.0, 0.7]).astype(np.float32)
    r = np.linalg.norm(pos, axis=2)
    order = np.argsort(r, axis=1)
    pos = np.take_along_axis(pos, order[..., None], 1)
    r = np.take_along_axis(r, order, 1)
    w = rng.lognormal(0.0, 0.3, (B, K)).astype(np.float32)
    sel = rng.random((B, K)) < 0.9
    masks = np.stack([sel, sel], 1)
    rmed = np.median(r, axis=1).astype(np.float32)
    R = np.stack([1.5 * rmed, 1.2 * rmed], 1)
    return w, pos, masks, R


def phase_k2(dev):
    rng = np.random.default_rng(2)
    cells = {}
    for name, B, K in (("main", 256, 32768), ("giant", 1, 1 << 20)):
        w, pos, masks, R = (torch.from_numpy(x).to(dev) for x in _cloud(rng, B, K))
        args, enough = pack_inertia_inputs(w, pos, masks, R, [False, True], [True, True])
        got = il.inertia_loop(*args)
        ref = il.inertia_loop_plain(*args)
        torch.cuda.synchronize()
        g, r = got.cpu().numpy(), ref.cpu().numpy()
        err = np.abs(g - r)
        tol = K2_RTOL * np.abs(r) + 1e-7 * np.abs(r).max()
        if not np.isfinite(g).all() or (err > tol).any():
            raise AssertionError(
                f"K2 {name}: {(err > tol).sum()} of {err.size} values off "
                f"(max abs err {err.max():.3e})"
            )
        ms = time_ms(lambda: il.inertia_loop(*args))
        plain_ms = time_ms(lambda: il.inertia_loop_plain(*args))
        cells[name] = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms)
        say("K2", f"{name} B={B} K={K} C=2: within rtol {K2_RTOL} "
            f"(max abs err {err.max():.3e}, found {int(enough.sum())}/{enough.numel()}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return cells


def _bench_inputs(uni, device):
    """Context, staged chunk and process() arguments for a mock DMO
    universe, as the bench DMO configuration builds them."""
    groupnr = np.full(len(uni.ids), -1, dtype=np.int64)
    id_to_row = np.empty(int(uni.ids.max()) + 1, dtype=np.int64)
    id_to_row[uni.ids] = np.arange(len(uni.ids))
    for hi, ids in enumerate(uni.bound_ids):
        groupnr[id_to_row[ids]] = hi
    rho_crit0 = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * G)
    E2 = uni.omega_m / uni.a**3 + uni.omega_lambda
    fields = {
        "Masses": uni.mass.astype(np.float32),
        "Velocities": uni.vel.astype(np.float32),
        "GroupNr_bound": groupnr,
        "FOFGroupIDs": uni.fof_ids,
    }
    chunk = ChunkData(
        boxsize=uni.boxsize,
        ptypes={"PartType1": stage_ptype(uni.pos, fields, uni.boxsize, device)},
    )
    ctx = HaloContext(
        a=uni.a, z=1.0 / uni.a - 1.0, G=G, boxsize=uni.boxsize,
        critical_density=rho_crit0 * E2,
        mean_density=rho_crit0 * uni.omega_m / uni.a**3,
        softening=(0.01,), ptypes=("PartType1",), capacities=(0,), dmo=True,
    )
    H = uni.n_halos
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=uni.halo_renclose * uni.a * 1.01,
        index=np.arange(H, dtype=np.int64),
        is_central=np.ones(H, dtype=bool),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
    )
    return ctx, chunk, args


def _compare(ref, got):
    """The CPU slice test's tolerances: counts equal; r, Mtot and
    HalfMassRadiusTot within rtol 1e-5; the rest within rtol 1e-3 and
    atol 1e-4 max|ref| per key."""
    for group in ref:
        for key in ref[group]:
            a = np.asarray(ref[group][key], np.float64)
            b = np.asarray(got[group][key], np.float64)
            if key == "Ndm":
                ok = np.array_equal(a, b)
            elif key in ("r", "Mtot", "HalfMassRadiusTot"):
                ok = np.allclose(b, a, rtol=1e-5, atol=0.0)
            else:
                scale = np.abs(a).max() if a.size else 1.0
                ok = np.allclose(b, a, rtol=1e-3, atol=1e-4 * max(scale, 1e-30))
            if not ok:
                raise AssertionError(f"{group}/{key}: GPU engine differs from CPU")


def phase_engine(dev):
    """Every fourth halo a satellite, and every third halo's search radius
    shrunk so far that it must go round the x1.5 retry ladder, as in the
    CPU slice test."""
    uni = build_mock_universe(n_halos=64, n_field=20000, boxsize=40.0, seed=ENGINE_SEED)
    H = uni.n_halos
    shrink = np.where(np.arange(H) % 3 == 0, 0.002, 1.0)
    runs = {}
    for where in ("cpu", dev):
        ctx, chunk, args = _bench_inputs(uni, torch.device(where))
        args["is_central"] = np.arange(H) % 4 != 0
        args["search_radius_phys"] = args["search_radius_phys"] * shrink
        rg.launches = il.launches = 0
        eng = HaloEngine(ctx, chunk, slice_specs(), where)
        runs[str(where)] = (eng.process(**args), eng.stats, rg.launches, il.launches)
    (ref, st_c, _, _), (got, st_g, n1, n2) = runs["cpu"], runs[str(dev)]
    _compare(ref, got)
    if st_g.n_retries == 0:
        raise AssertionError("the retry ladder did not run on the GPU")
    if (st_c.n_bucket_calls, st_c.n_retries) != (st_g.n_bucket_calls, st_g.n_retries):
        raise AssertionError(
            f"bucket calls / retries differ: CPU {st_c.n_bucket_calls}/"
            f"{st_c.n_retries}, GPU {st_g.n_bucket_calls}/{st_g.n_retries}"
        )
    if n1 == 0 or n2 == 0:
        raise AssertionError(f"GPU engine bypassed a kernel: K1 {n1}, K2 {n2} launches")
    say("engine", f"{H} halos, {len(uni.pos)} particles: GPU == CPU within "
        f"tolerance; {st_g.n_bucket_calls} bucket calls, {st_g.n_retries} "
        f"retries; launches K1 {n1}, K2 {n2}")


def phase_main(dev):
    t0 = time.perf_counter()
    uni = build_mock_universe(**BENCH)
    t1 = time.perf_counter()
    ctx, chunk, args = _bench_inputs(uni, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    say("main", f"universe {len(uni.pos)} particles, {uni.n_halos} halos in "
        f"{t1 - t0:.1f} s; staged on the GPU in {t2 - t1:.2f} s "
        f"({chunk.ptypes['PartType1'].packed.shape[0]} rows)")
    HaloEngine(ctx, chunk, slice_specs(), dev).process(**args)  # warm pass

    engine = HaloEngine(ctx, chunk, slice_specs(), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rg.launches = il.launches = 0
    t3 = time.perf_counter()
    res = engine.process(**args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t3
    launches = {"range_gather": rg.launches, "inertia_loop": il.launches}

    H = uni.n_halos
    for group, d in res.items():
        for key, arr in d.items():
            if arr.shape[0] != H or not np.isfinite(np.asarray(arr, np.float64)).all():
                raise AssertionError(f"{group}/{key}: shape {arr.shape} or non-finite")
    if not (res["BoundSubhalo"]["Mtot"] > 0).all():
        raise AssertionError("BoundSubhalo/Mtot not positive for every halo")
    if not (res["SO/200_crit"]["r"][args["is_central"]] > 0).all():
        raise AssertionError("SO/200_crit/r not positive for every central")
    if min(launches.values()) == 0:
        raise AssertionError(f"main path bypassed a kernel: {launches}")
    say("main", f"{H} halos in {dt:.3f} s -> {H / dt:.2f} halos/s; "
        f"{engine.stats.n_bucket_calls} bucket calls, {engine.stats.n_retries} "
        f"retries; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    say("device", f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)["main"]
    phase_engine(dev)
    launches = phase_main(dev)

    kernels = [
        dict(name="range_gather", route="cuda",
             source="soap_tpu_torch/csrc/range_gather.cu",
             replaces="soap_tpu/ops/dma_gather.py:247",
             launches=launches["range_gather"], **k1),
        dict(name="inertia_loop", route="cuda",
             source="soap_tpu_torch/csrc/inertia_loop.cu",
             replaces="soap_tpu/ops/pallas_inertia.py:461",
             launches=launches["inertia_loop"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
