#!/usr/bin/env python3
"""Smoke run of soap_tpu_torch on one NVIDIA GPU: build, check, drive.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py            # add --profile for kernel profiles
                                     # (main, hydro and COLIBRE paths)
    python3 chip_smoke.py --multi-device-only   # phases 11 and 19
    python3 chip_smoke.py --kernels-only        # phases 1-4 and 4s

Phases, each printing its lines and raising on failure:
 1. device: nvidia-smi's name and power limit, torch and CUDA versions;
 2. build: the three CUDA kernels from soap_tpu_torch/csrc into
    build/soap_tpu_torch, one nvcc per source, started together;
 3. K1 (range gather) against its plain version at two cells, a 10.5M x
    16 store (DMO rows) and a 1.5M x 128 one (the hydro path's gas rows),
    timed beside the one PyTorch call that computes the same rows
    (torch.index_select on the precomputed row index);
 4. K2 (inertia loop) against its plain version at six cells: the bound
    spec's (B=256, K=32768, C=2; one CTA per halo), an SO family's 8
    densities x 4 configs on the same rows, folded into C=32 or, as the
    engine lays them, as 8 x 256 halos at C=4, a middle one (B=64,
    K=131072; clusters of 2), one giant halo (B=1, K=2^20; a cluster of
    16) and the luminosity-weighted stellar configs' (9 bands x 256 star
    segments of 4096 rows on the halo axis, C=2), each also launched
    twice for torch.equal results;
 4s. K3 (particle sums) at K3_CELLS against the float64 path
    ``x.double().sum(dim)`` (float32 out: equal in every element but
    float64 rounding ties, which it counts; float64 out: within another
    order's rounding), launched twice for torch.equal results, timed on
    the card (calls queued behind a spin, so the host's issue is hidden)
    beside the plain path it replaces (``x.sum(dim,
    dtype=torch.float64).to(torch.float32)``, or the float64 copy and sum
    for float64 out), and the host's microseconds to issue a call of each;
 5. the engine on the GPU against the engine on the CPU, with the full
    DMO production spec list and catalogue EncloseRadius, on a 64-halo
    mock with satellites, understated EncloseRadius (the truncation
    cross-check sends halos round the retry ladder), aperture copies
    and both the narrow and the wide pass;
 5h. the same for the default hydro list (38 calculations, 4729 keys) on
    the CPU hydro test's 8-halo mock of gas, dark matter, stars and black
    holes: every key within the tests' tolerances, equal counters, K1
    launched for every particle type, K2 for gas, star and luminosity
    configs;
 5c. bucket capacity: phase 5's DMO run and phase 5h's hydro run, and
    both at the catalogue's EncloseRadius, on the GPU twice: with tile
    caps of CAPACITY_ROW_FACTOR times the row budget and the default
    halo cap (each round in one bucket), and of the row budget and one
    halo per bucket, so a halo's rows are padded to the largest of its
    round or to its own (the phase prints the ratio per halo); every key
    of the two runs must be bit-equal, but
    the keys CAPACITY_EXCEPTIONS names for phases 5 and 5h (their
    understated EncloseRadius makes the aperture copy plan-dependent);
 5n. neutrino delta-f weights: phase 5h's mock with a PartType6 population
    (``utils/mock_data.py::add_neutrinos``: masses and weights, about half
    of them negative) and FLAMINGO's SO groups (the ones that read
    neutrinos), GPU against CPU at the parity tolerances, K1 launched for
    PartType6;
 5p. the same for the COLIBRE_THERMAL (50 calculations, 4114 keys) and
    FLAMINGO (38, 2103) parameter files' lists and contexts on that mock,
    and for COLIBRE_THERMAL's new spec kinds with every property enabled
    (the files switch their iterative inertia tensors off): the family
    of four core-excised SOs, a 50 kpc fixed-radius SO and the apertures
    of twice the stellar half-mass radius, with K2 launched for the
    core-excised family and the property-sized apertures;
 5e. the entry's in-memory half (``pipeline/run.py::build_catalogue``) on
    the GPU against the CPU: the DMO list on phase 5's mock and
    FLAMINGO's file on phase 5h's, each from the mock's metadata, HBTplus
    catalogue and fields as the JAX readers read them back from its files;
    the two catalogues have the same datasets, dtypes, shapes and
    attributes, exactly equal sort order, passthrough, SOAP/* and integer
    columns, and floats within utils/parity.py's tolerances;
 6. the main path: bench.py::bench_dmo's run (2048 halos, 9.62M
    particles, the full spec list of 38 calculations and 508 keys, with
    EncloseRadius): a warm pass, then TIMED_PASSES timed passes, each
    with every launch counter set to 0 just before it and read just
    after, then a checked pass that holds every K1, K2 and K3 call
    against its plain version at the shapes the path gives it (K3
    against the float64 path: float32 equal but at counted rounding
    ties, float64 within 2 K u sum|x|), as many calls as the timed pass
    launched;
 7. the giant-halo path: bench.py's giant configuration (6 halos of
    0.9-1.6M particles) with the engine slice's small spec set (2
    calculations, 12 keys) and GIANT_TIMED_PASSES timed passes (the full
    list and five passes at this size would not fit the run's time
    limit), where K2 runs in clusters;
 8. the hydro path: bench.py::bench_hydro's universe at the DMO path's
    2048 halos (~11M particles in four types), built in memory with no
    file, with the full default hydro list and EncloseRadius, through
    the same passes (HYDRO_TIMED_PASSES timed ones), reporting K1
    launches by particle type and K2 launches by config kind;
 9. the COLIBRE path: the same universe with the COLIBRE_THERMAL
    parameter file's list (50 calculations, 4114 keys: core-excised SOs,
    apertures from 100 pc to 100 kpc, property-sized apertures) and
    context, through the same passes.  The list has no iterative inertia
    tensor, so K2 does not run on it; K1 must launch for every type;
 10. the COLIBRE every-key path: the same universe with phase 5p's
    every-key list (11 calculations, 1390 keys), where K2 runs for the
    core-excised SO family and the property-sized spheres at full size;
 11. the DMO entry: phase 6's universe through build_catalogue with its
    own mock HBTplus catalogue and the default DMO list: a warm pass,
    TIMED_PASSES timed passes reporting entry halos/s, the seconds before,
    in and after the engine, peak memory and the launches, then a
    checked pass holding every K1 and K2 call against its plain version;
 12. the FLAMINGO entry: phase 8's universe with FLAMINGO's list and
    context (5 cMpc read radius floor, category filters at 100
    particles, disabled keys dropped, the reduced-snapshot flag, K2 for
    the bound subhalo), the same passes with HYDRO_TIMED_PASSES;
 13. the chunked DMO entry: phase 11's inputs at ENTRY_CHUNKS Peano–Hilbert
    chunks with the in-memory reader and read-ahead staging (chunk N+1
    read and staged on a side stream while chunk N computes), the same
    passes with CHUNKED_TIMED_PASSES timed ones, printing per chunk the
    read-and-stage seconds in the reader thread, the main thread's wait
    and the engine's seconds, the particles staged against one chunk's,
    device memory after each chunk and the peak; the catalogue must equal phase 11's, memory
    after each chunk stay within the baseline plus the next prestaged
    store, and a prestaged store equal the same chunk staged serially;
    then one pass without read-ahead;
 13t. the chunk loop with per-halo and per-property timings: phase 5's
    mock at TIMING_CHUNKS chunks, GPU against CPU (equal catalogues and
    n_loop, process_time > 0, every _time dataset >= 0 with a positive
    sum and equal within a spec);
 14. the chunked FLAMINGO entry: phase 12's inputs as phase 13 runs
    phase 11's, FLAMINGO_CHUNKED_PASSES timed passes, against phase 12;
 15. the FLAMINGO entry with neutrinos: phase 12's universe and file with a
    PartType6 population of NU_RATIO of its dark matter count (FLAMINGO
    L1_m9's 1000^3 neutrinos to 1800^3 dark matter particles), a warm, a
    timed and a checked pass; RawNeutrinoMass, NoiseSuppressedNeutrinoMass
    and NumberOfNeutrinoParticles of the 16 most massive centrals against
    float64 numpy sums inside the SO radius the port reports;
 16. the membership program's in-memory join on the card's host: phase 6's
    universe's IDs, in its snapshot order, against its bound lists;
    GroupNr_bound and Rank_bound must equal the labels the mock gives;
    then against the same bound lists as a VR catalogue holds them (four
    files with local offsets, ``io/finder_readers.py::vr_groupnr``):
    GroupNr_bound the same, Rank_bound 0 for every bound particle (VR
    gives no rank: the reference's fault, ported as it is);
 17. the entry under the other finders: phase 11's HBTplus catalogue
    expressed as each other finder stores it
    (``utils/mock_finders.py``): VR, Gadget-4 SubFind and EAGLE SubFind
    through their readers' array halves, Rockstar through an ASCII
    ``out_*.list`` and through four binary ``halos_*.bin`` chunks written
    to a temporary directory and read back; each through build_catalogue
    with phase 11's inputs otherwise (a warm pass, FINDER_TIMED_PASSES
    timed passes, a checked pass); centrality and bound counts must be
    phase 11's, every property group (BoundSubhalo, SO, ExclusiveSphere,
    InclusiveSphere, ProjectedAperture) equal to phase 11's catalogue at
    utils/parity.py's tolerances (the binary chunks' float32 centres: to
    an HBTplus run at those centres), the sort order the same, InputHalos
    the same but for the finder's passthrough, and no SOAP/* columns; the
    phase prints which finders' groups are bit-equal;
 17c. VR and Rockstar (ASCII) on phase 5's mock (with satellites) through
    build_catalogue at 1 and at 3 chunks, GPU against CPU (phase 5e's
    check);
 18. the X-ray recalculation: the hydro path's 1.37M gas particles
    (densities, temperatures, element mass fractions, masses) against a
    5D table built in memory (``tools/xray_calculator.py::mock_table_5d``,
    every default band and observing type) through
    ``XrayCalculator.interpolate`` on the GPU and on the CPU: equal within
    rtol 1e-12 in float64; timed;
 19. halo batches over several devices (``parallel/sharded.py``): every
    local GPU, or two workers on card 0 when there is one card: phase 5's
    mock through ``ShardedHaloEngine`` bit-equal to ``HaloEngine`` on
    card 0; two chunks with a satellite, each on its group, bit-equal to
    each chunk on card 0; phase 11's entry over the list (a warm, a timed
    and a checked pass holding every K1 and K2 call of every device
    against its plain version; halos/s beside phase 11's, shares and
    seconds per worker, peak memory per card; the catalogue bit-equal to
    phase 11's; with several cards, launches on each); and
    ``graft_entry.dryrun_multichip`` on the list;
 20. the command line's file tools on the card's host (no h5py, no jax):
    every ``soap_tpu_torch/tools`` module and the parser import, the
    parser lists the sixteen subcommands, and the tools' array halves run
    at the earlier phases' sizes, each timed: ``match_sim`` both ways
    between phase 6's universe and a relabelled copy (the relabelling
    recovered exactly, every match consistent), the membership label
    check on phase 16's labels (passes; raises after one corrupted
    label), the hydrogen fractions of phase 8's gas (in [0, 1], HI + HII
    + 2 H2 = 1 to 1e-12), ``build_matrix`` on phase 11's inertia tensors
    (symmetric, round-trips), the timing statistics of phase 13t's
    catalogue, and both documentation generators (a row per property).
It then prints the kernels' JSON line (each cell's time beside its
plain version's, the least time the card could take for the same work,
and the library call's; each path's launches and checked calls), the
card's nvidia-smi line, and last a JSON object with "ok": true.  With
``--multi-device-only`` it builds the kernels and runs phases 11 and 19
alone (for a machine with several cards), then prints the last two;
with ``--kernels-only`` phases 1-4 and 4s, then the kernels' JSON line
of their cells and the last two.
Without a CUDA device it exits 1 before printing any result.  Imports
torch, numpy and soap_tpu_torch only.
"""

import dataclasses
import importlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from soap_tpu_torch import cli, graft_entry
from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.models import halo_slice as hs
from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
from soap_tpu_torch.io.finder_readers import vr_groupnr
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.ops import inertia as inertia_ops
from soap_tpu_torch.ops import inertia_loop as il
from soap_tpu_torch.ops import kernel_lib
from soap_tpu_torch.ops import range_gather as rg
from soap_tpu_torch.ops import reductions as red
from soap_tpu_torch.ops.inertia import pack_inertia_inputs
from soap_tpu_torch.pipeline.chunk_data import ChunkData, stage_ptype
from soap_tpu_torch.parallel.domain import peano_decomposition
from soap_tpu_torch.parallel.sharded import ShardedHaloEngine, device_grid
from soap_tpu_torch.pipeline import chunks
from soap_tpu_torch.pipeline.chunks import mock_fields, stage_chunk
from soap_tpu_torch.pipeline import engine as engine_mod
from soap_tpu_torch.pipeline.engine import HaloEngine
from soap_tpu_torch.pipeline.membership import compute_membership
from soap_tpu_torch.pipeline.run import (
    age_table, build_catalogue, entry_plan, make_context, mock_catalogue, mock_metadata,
)
from soap_tpu_torch.pipeline.specs import build_specs, slice_specs
from soap_tpu_torch.tools import docs, fof_radii, hydrogen_phases, match_membership
from soap_tpu_torch.tools import membership_checks, timing_analysis
from soap_tpu_torch.tools import xray_calculator as xc
from soap_tpu_torch.utils.mock_data import G_INTERNAL as G
from soap_tpu_torch.utils.mock_data import add_neutrinos, build_mock_universe, snapshot_attrs
from soap_tpu_torch.utils.mock_finders import finder_catalogue
from soap_tpu_torch.utils.parity import (
    catalogue_differences, is_loose, key_close, scaled_error,
)

K2_RTOL = 2e-5  # kernel vs plain loop: tensors, plus atol 1e-7 max|ref|
TIMED_PASSES = 5  # per engine path
HYDRO_TIMED_PASSES = 1  # the hydro, COLIBRE and FLAMINGO paths', to fit the run's time limit
CHUNKED_TIMED_PASSES = 3  # the chunked main entry's, to fit the run's time limit
GIANT_TIMED_PASSES = 3  # the giant path's, cut to fit the run's time limit
FLAMINGO_CHUNKED_PASSES = 1  # the chunked FLAMINGO entry's, to fit the time limit
NU_TIMED_PASSES = 1  # the FLAMINGO entry with neutrinos', to fit the time limit
#: neutrinos per dark matter particle (FLAMINGO L1_m9: 1000^3 to 1800^3)
NU_RATIO = 0.17
NU_SEED = 6
ENGINE_SEED = 11
BENCH = dict(
    n_halos=2048, n_field=400000, boxsize=170.0, seed=20260816,
    mass_range=(3.2, 3000.0),
)
#: bench.py::bench_giant's universe
GIANT = dict(
    n_halos=6, n_field=200_000, boxsize=170.0, seed=4242,
    mass_range=(9.0e4, 1.6e5),
)
#: bench.py::bench_hydro's universe, at the DMO headline's 2048 halos
HYDRO = dict(
    n_halos=2048, n_field=100_000, boxsize=100.0, seed=20260817, hydro=True,
    mass_range=(3.2, 3000.0),
)
#: phase 5's DMO mock (satellites, coarse particles over a wide mass range)
ENGINE_MOCK = dict(
    n_halos=64, n_field=20000, boxsize=40.0, seed=ENGINE_SEED, particle_mass=2.0,
    mass_range=(300.0, 30000.0), n_satellites=2,
)
#: phase 5h's small hydro mock (tests/test_torch_engine_hydro.py's)
HYDRO_SMALL = dict(
    n_halos=6, n_field=1000, boxsize=16.0, seed=101, hydro=True, n_satellites=2,
    particle_mass=4.0, mass_range=(100.0, 5000.0),
)
#: K1 cells: name, store rows N, columns F, halos B, capacity, S, ranges;
#: "gas": the hydro path's gas store (128 columns, no alignment head)
K1_CELLS = (
    ("main", 10_500_000, 16, 1024, 8192, 64, 32),
    ("gas", 1_500_000, 128, 256, 4096, 64, 32),
)
#: K2 cells: name, B, K, C, L.  L = 8: an SO family's 8 members x 4
#: configs, folded into the config axis (C = 32, B halos) or, as the
#: engine runs it, laid on the halo axis (C = 4, 8 x B halos); the two
#: cells hold the same clouds
K2_CELLS = (
    ("main", 256, 32768, 2, 1), ("family", 256, 32768, 32, 1),
    ("family-lanes", 256, 32768, 4, 8),
    ("middle", 64, 131072, 2, 1), ("giant", 1, 1 << 20, 2, 1),
    # the luminosity-weighted stellar configs: 9 bands x 256 halos' star
    # segments on the halo axis, each lane its band's weights, C = 2
    ("band-lanes", 256, 4096, 2, 9),
)
#: K3 cells: name, shape, reduced axis, output dtype, masked: a bucket's
#: mass sums, an SO family's 32 configs' inertia sums into float64, one
#: giant halo's row (split over warps, then the finishing kernel) and a
#: bucket's masked position sums
K3_CELLS = (
    ("rows", (1024, 8192), 1, torch.float32, False),
    ("configs-f64", (256, 32, 32768), -1, torch.float64, False),
    ("giant", (1, 1 << 20), 1, torch.float32, False),
    # a bucket's masked position sums: rows of stride 3, read in place
    ("positions", (512, 4096, 3), 1, torch.float32, True),
)
#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
#: HBM bytes/s and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: K2's operations per selected row, config and iteration: the
#: ellipsoid's quadratic form (14) and test (1), the six weighted second
#: moments (12 products) and the seven sums
K2_FLOPS_PER_ROW = 34


#: the run's start, for the seconds each line prints
T_START = time.perf_counter()


def say(phase, msg):
    print(f"[{phase} {time.perf_counter() - T_START:.1f}s] {msg}", flush=True)


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


def device_ms(fn, n=20, reps=5):
    """Median of ``reps`` device timings of one call of ``fn``: ``n``
    calls queued behind a spin of the card, between two CUDA events, so
    that the host's time to issue them is hidden (after one warm call)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)  # ~1 ms of spinning: the host queues meanwhile
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    return float(np.median(times))


def host_us(fn, n=200):
    """Host microseconds to issue one call of ``fn`` (``n`` in a row,
    after one warm call; the card works behind them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound_ms(n_bytes, n_ops):
    """(least time in ms, what bounds it): the larger of the bytes over
    the card's memory rate and the operations over its f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(packed, table, S, capacity):
    """K1's bound: each output row written once, each distinct source
    row this table reaches read once, the table read once."""
    N, F = packed.shape
    off = torch.arange(S, device=table.device)
    src = torch.clamp(table.to(torch.int64)[..., None] + off, 0, N - 1)
    n_src = int(torch.unique(src).numel())
    B = table.shape[0]
    return bound_ms((B * capacity + n_src) * F * 4 + table.numel() * 4, 0)


def k2_bound(args):
    """K2's bound for these inputs: each halo's rows up to its last
    selected row read once (positions, weight, mask words), the tensors
    written once; K2_FLOPS_PER_ROW for every selected row of every
    iteration each config runs (counted by the plain version)."""
    pos3, _, mw, R, _, _, occ = args[:7]
    W = mw.shape[1]
    _, iters = il.inertia_loop_plain(*args, count_iterations=True)
    rows = occ.amax(1).to(torch.float64).sum().item()
    n_bytes = rows * (12 + 4 + 4 * W) + R.numel() * (6 * 4 + 5 * 4)
    n_ops = K2_FLOPS_PER_ROW * (iters.to(torch.float64) * occ).sum().item()
    return bound_ms(n_bytes, n_ops)


# ---------------------------------------------------------------- phases


def phase_build():
    t0 = time.perf_counter()
    names = ("range_gather", "inertia_loop", "particle_sum")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(kernel_lib.build, names))
    for name in names:
        kernel_lib.load(name)
    say("build", f"{' + '.join(names)} into {kernel_lib.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {kernel_lib.BUILD_SECONDS})")


def phase_k1(dev, cell):
    name, N, F, B, cap, S, n_ranges = cell
    rng = np.random.default_rng([1, F])
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
    # the library call: one index_select on the precomputed row index
    idx = torch.clamp(
        table.to(torch.int64)[..., None] + torch.arange(S, device=dev), 0, N - 1
    ).reshape(-1)
    lib = torch.index_select(packed, 0, idx).view(B, cap, F)
    if not torch.equal(lib, got):
        raise AssertionError("index_select differs from K1")
    del got, ref, lib
    ms = time_ms(lambda: rg.range_gather_blocks(packed, table, S, cap))
    plain_ms = time_ms(lambda: rg.range_gather_blocks_plain(packed, table, S, cap))
    library_ms = time_ms(lambda: torch.index_select(packed, 0, idx))
    bms, by = k1_bound(packed, table, S, cap)
    gbs = 2 * B * cap * F * 4 / (ms * 1e-3) / 1e9
    say("K1", f"{name} B={B} capacity={cap} F={F} store={N}x{F}: torch.equal ok "
        f"(max abs err {err:.3e}); kernel {ms:.4f} ms ({gbs:.0f} GB/s moved), "
        f"plain {plain_ms:.4f} ms, index_select {library_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by})")
    return dict(cell=f"N={N} F={F} B={B} capacity={cap}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def _cloud(rng, B, K, C):
    """Radius-sorted triaxial clouds, selections, sphere radii and
    reduced flags.  C = 2: the bound spec's two configs; C = 32: an SO
    family's, 8 sphere radii x (plain, reduced) x 2 species, member-major."""
    pos = (rng.normal(size=(B, K, 3)) * [1.5, 1.0, 0.7]).astype(np.float32)
    r = np.linalg.norm(pos, axis=2)
    order = np.argsort(r, axis=1)
    pos = np.take_along_axis(pos, order[..., None], 1)
    r = np.take_along_axis(r, order, 1)
    w = rng.lognormal(0.0, 0.3, (B, K)).astype(np.float32)
    sel = rng.random((B, K)) < 0.9
    masks = np.stack([sel] * C, 1)
    rmed = np.median(r, axis=1).astype(np.float32)
    if C == 2:
        scale = np.array([1.5, 1.2], np.float32)
    else:
        scale = np.repeat(np.linspace(0.4, 1.6, C // 4), 4).astype(np.float32)
    R = rmed[:, None] * scale[None, :]
    return w, pos, masks, R, [c % 2 == 1 for c in range(C)]


def k2_err(what, got, ref):
    """Max abs error of K2 against its plain version; raises on a
    non-finite value or one outside rtol K2_RTOL + atol 1e-7 max|ref|."""
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    if not g.size:
        return 0.0
    err = np.abs(g - r)
    tol = K2_RTOL * np.abs(r) + 1e-7 * np.abs(r).max()
    if not np.isfinite(g).all() or (err > tol).any():
        raise AssertionError(
            f"K2 {what}: {(err > tol).sum()} of {err.size} values off "
            f"(max abs err {err.max():.3e})"
        )
    return float(err.max())


def phase_k2(dev):
    cells = {}
    for name, B, K, C, L in K2_CELLS:
        # one seed per cloud shape: the family cells share their clouds
        rng = np.random.default_rng([2, B, K, C * L])
        *arrays, reduced = _cloud(rng, B, K, C * (1 if name == "band-lanes" else L))
        w, pos, masks, R = (torch.from_numpy(x).to(dev) for x in arrays)
        if name == "band-lanes":  # band n of halo b becomes halo n * B + b
            lum = 10.0 ** rng.uniform(6.0, 9.0, (L, B, K)).astype(np.float32)
            w = torch.from_numpy(lum.reshape(L * B, K)).to(dev)
            pos, masks, R = pos.repeat(L, 1, 1), masks.repeat(L, 1, 1), R.repeat(L, 1)
            B = L * B
        elif L > 1:  # member m of halo b becomes halo m * B + b
            w, pos = w.repeat(L, 1), pos.repeat(L, 1, 1)
            masks = masks.view(B, L, C, K).transpose(0, 1).reshape(L * B, C, K)
            R = R.view(B, L, C).transpose(0, 1).reshape(L * B, C)
            reduced = reduced[:C]
            B = L * B
        args, enough = pack_inertia_inputs(w, pos, masks, R, reduced, [True] * C)

        def kernel():
            return il.inertia_loop(*args, rows_radius_sorted=True)

        il.cluster_launches.clear()
        got = kernel()
        again = kernel()
        ref = il.inertia_loop_plain(*args)
        torch.cuda.synchronize()
        (G,) = il.cluster_launches
        if not torch.equal(got, again):
            raise AssertionError(f"K2 {name}: two launches differ")
        err = k2_err(name, got, ref)
        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: il.inertia_loop_plain(*args), reps=3)
        bms, by = k2_bound(args)
        cells[name] = dict(cell=f"B={B} K={K} C={C}", cluster_size=G,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, library_ms=None)
        say("K2", f"{name} B={B} K={K} C={C} G={G}: within rtol {K2_RTOL}, two "
            f"launches torch.equal (max abs err {err:.3e}, found "
            f"{int(enough.sum())}/{enough.numel()}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del w, pos, masks, R, args, got, again, ref
        torch.cuda.empty_cache()
    return cells


def k3_ties(got, x, dim):
    """(elements off, of them at float64 rounding ties): ``got`` (float32)
    against the float32 rounding of ``x.double().sum(dim)``; a tie is one
    ulp off with the two float32 values' midpoint within 2 K u sum|x| of
    that float64 sum, the most two orders of its additions can differ."""
    s64 = x.double().sum(dim)
    want = s64.float()
    diff = (got != want) & ~(got.isnan() & want.isnan())
    mid = (got.double() + want.double()) / 2
    bound = 2 * x.shape[dim] * 2.0**-53 * x.double().abs().sum(dim)
    tie = diff & (torch.nextafter(want, got) == got) & ((mid - s64).abs() <= bound)
    return int(diff.sum()), int(tie.sum())


def k3_against_float64(got, x, dim, mask):
    """(elements off, of them at float64 rounding ties): K3's ``got``
    against ``x.double().sum(dim)`` over the ``mask``-selected elements,
    float32 results as ``k3_ties`` holds them, float64 ones within 2 K u
    sum|x| of it (no tie).  Taken over slices of the leading axis, so the
    float64 copies stay small beside an engine pass's own tensors."""
    dim = dim % x.dim()
    m = None if mask is None else red._trailing(mask, x.dim()).expand(x.shape)
    step = max(1, (1 << 26) // max(1, x[0].numel())) if dim and len(x) else max(1, len(x))
    off = ties = 0
    for i in range(0, max(1, len(x)) if dim else 1, step):
        xs, gs = (x[i : i + step], got[i : i + step]) if dim else (x, got)
        if m is not None:
            xs = torch.where(m[i : i + step] if dim else m, xs, 0)
        if gs.dtype == torch.float32:
            o, t = k3_ties(gs, xs, dim)
            off, ties = off + o, ties + t
        else:
            s64 = xs.double().sum(dim)
            bound = 2 * x.shape[dim] * 2.0**-53 * xs.double().abs().sum(dim)
            ok = (gs == s64) | ((gs - s64).abs() <= bound) | (gs.isnan() & s64.isnan())
            off += int((~ok).sum())
    return off, ties


def phase_k3(dev):
    cells = {}
    for name, shape, dim, out_dtype, masked in K3_CELLS:
        rng = np.random.default_rng([3, *shape])
        x = torch.from_numpy(rng.lognormal(0.0, 2.0, shape).astype(np.float32)).to(dev)
        mask = None
        if masked:  # one selection over the particle axis, shared by the columns
            mask = torch.from_numpy(rng.random(shape[:2]) < 0.7).to(dev)
        od = None if out_dtype == x.dtype else out_dtype
        n0 = red.launches
        got = red.particle_sum(red.Summand(x, mask, od), dim)
        again = red.particle_sum(red.Summand(x, mask, od), dim)
        torch.cuda.synchronize()
        if red.launches - n0 != 2:
            raise AssertionError(f"K3 {name}: {red.launches - n0} launches, not 2")
        if not torch.equal(got, again):
            raise AssertionError(f"K3 {name}: two launches differ")
        xm = x if mask is None else torch.where(mask[..., None], x, 0.0)
        if out_dtype == torch.float32:
            off, ties = k3_ties(got, xm, dim)
            if off != ties:
                raise AssertionError(f"K3 {name}: {off - ties} elements off beyond a tie")
            check = f"float32 equal to the float64 path but {ties} ties"

            def plain(x, mask):
                if mask is not None:
                    x = torch.where(mask[..., None], x, 0.0)
                return x.sum(dim, dtype=torch.float64).to(torch.float32)
        else:
            s64 = xm.double().sum(dim)
            err = ((got - s64).abs() / (x.shape[dim] * 2.0**-53 * xm.double().abs().sum(dim)))
            if float(err.max()) > 2.0:
                raise AssertionError(f"K3 {name}: float64 {float(err.max()):.3f} K u sum|x| off")
            check = f"float64 within {float(err.max()):.3f} K u sum|x| of the float64 path"

            def plain(x, mask):
                return x.to(torch.float64).sum(dim, dtype=torch.float64)
        del got, again, xm
        # copies of the inputs, taken in turn, over more than twice the
        # 50 MB L2, so that every call reads its input from device memory
        n_bytes_in = x.numel() * 4 + (0 if mask is None else mask.numel())
        inputs = [(x, mask)] + [(x.clone(), None if mask is None else mask.clone())
                                for _ in range(-(-(120 << 20) // n_bytes_in) - 1)]
        turn = itertools.cycle(inputs)

        def kernel():
            xi, mi = next(turn)
            return red.particle_sum(red.Summand(xi, mi, od), dim)

        def plain_turn():
            return plain(*next(turn))
        ms, plain_ms = device_ms(kernel), device_ms(plain_turn)
        us, plain_us = host_us(kernel), host_us(plain_turn)
        n_out = x.numel() // x.shape[dim]
        n_bytes = n_bytes_in + n_out * (8 if out_dtype == torch.float64 else 4)
        bms, by = bound_ms(n_bytes, 0)
        cell = f"shape={tuple(shape)} dim={dim} out={out_dtype}{' masked' if masked else ''}"
        cells[name] = dict(cell=cell, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           library_ms=None, host_us=us, plain_host_us=plain_us)
        say("K3", f"{name} {cell}: {check}, two launches torch.equal; kernel {ms:.4f} ms "
            f"({n_bytes / (ms * 1e-3) / 1e9:.0f} GB/s), plain {plain_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}); host {us:.1f} us a call, plain {plain_us:.1f} us")
        del x, mask, inputs
        torch.cuda.empty_cache()
    return cells


def _bench_inputs(uni, device):
    """Context, staged chunk, process() arguments (with the catalogue's
    EncloseRadius) and the full spec list for a mock DMO universe, as
    bench.py::bench_dmo builds them."""
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
    H = len(uni.halo_renclose)
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=uni.halo_renclose * uni.a * 1.01,
        index=np.arange(H, dtype=np.int64),
        is_central=np.ones(H, dtype=bool),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
        enclose_radius_phys=uni.halo_renclose * uni.a,
    )
    x = uni.omega_m / E2 - 1.0
    specs = build_specs(None, True, 18.0 * np.pi**2 + 82.0 * x - 39.0 * x * x)
    return ctx, chunk, args, specs


def _hydro_inputs(uni, device, parameter_file=None):
    """Context, staged chunk (gas, dark matter, stars, black holes, built
    in memory as the JAX reader would hand them over), process()
    arguments (all halos central, 1.01 x EncloseRadius, EncloseRadius)
    and the hydro spec list of a mock hydro universe: a shipped
    parameter file's list and context, ``every_key_specs`` with
    COLIBRE_THERMAL's context ("every-key"), or the defaults."""
    meta = mock_metadata(uni)
    params = None if parameter_file is None else ParameterFile(parameter_file_path(
        "COLIBRE_THERMAL" if parameter_file == "every-key" else parameter_file))
    if parameter_file == "every-key":
        specs = every_key_specs(meta.virBN98)
    else:
        specs = build_specs(params, False, meta.virBN98)
    ptypes = [pt for pt in meta.ptypes if meta.datasets[pt]]
    ctx = make_context(meta, ptypes, False, params)
    chunk = stage_chunk(mock_fields(uni, specs, meta, ptypes, age_table(meta)),
                        uni.boxsize, device)
    H = uni.n_halos
    args = dict(
        centres=uni.halo_pos,
        search_radius_phys=uni.halo_renclose * uni.a * 1.01,
        index=np.arange(H, dtype=np.int64),
        is_central=np.ones(H, dtype=bool),
        fof_id=np.arange(1, H + 1, dtype=np.int64),
        enclose_radius_phys=uni.halo_renclose * uni.a,
    )
    return ctx, chunk, args, specs


def _compare(ref, got):
    """The CPU parity tests' tolerances (``soap_tpu_torch/utils/parity.py``)
    on every key of every group; returns the largest scaled error of the
    loose keys and of the others."""
    worst = {"loose": 0.0, "other": 0.0}
    for group in ref:
        for key in ref[group]:
            if not key_close(ref[group][key], got[group][key], key):
                raise AssertionError(
                    f"{group}/{key}: GPU engine differs from CPU (scaled error "
                    f"{scaled_error(ref[group][key], got[group][key]):.3e})")
            cls = "loose" if is_loose(key) else "other"
            worst[cls] = max(worst[cls], scaled_error(ref[group][key], got[group][key]))
    return {k: float(f"{v:.3e}") for k, v in worst.items()}


def _counters(stats):
    return dict(bucket_calls=stats.n_bucket_calls, retries=stats.n_retries,
                copied_specs=stats.n_copied_specs,
                truncated_tiles=stats.n_truncated_tiles,
                by_pass=dict(sorted(stats.bucket_calls_by_pass.items())))


def engine_inputs(where, enclose_scale=0.3):
    """Phase 5's universe and inputs on one device: a 64-halo mock with
    two satellite subhalos of its biggest halo (they and every fourth
    halo satellites), coarse particles over a wide mass range (some halos
    past 1 Mpc), every third input radius shrunk x0.002 (floored at the
    pass's widest aperture) and every catalogue EncloseRadius understated
    x0.3 (times ``enclose_scale``), so the truncation misses bound rows of
    the biggest halos and the bound-count cross-check sends them round
    the x1.5 retry ladder."""
    uni = build_mock_universe(**ENGINE_MOCK)
    ctx, chunk, args, specs = _bench_inputs(uni, torch.device(where))
    H = len(uni.halo_renclose)
    args["is_central"] = (np.arange(H) % 4 != 0) & (np.asarray(uni.halo_rank) == 0)
    args["search_radius_phys"] = args["search_radius_phys"] * np.where(
        np.arange(H) % 3 == 0, 0.002, 1.0
    )
    args["enclose_radius_phys"] = args["enclose_radius_phys"] * enclose_scale
    return uni, (ctx, chunk, args, specs)


def engine_case(where, tile_caps=None, enclose_scale=0.3):
    """Phase 5's run on one device (``engine_inputs``)."""
    uni, (ctx, chunk, args, specs) = engine_inputs(where, enclose_scale)
    rg.launches = il.launches = 0
    eng = HaloEngine(ctx, chunk, specs, where, tile_caps=tile_caps)
    res = eng.process(**args)
    return uni, res, eng.stats, rg.launches, il.launches


def phase_engine(dev):
    uni, ref, st_c, _, _ = engine_case("cpu")
    _, got, st_g, n1, n2 = engine_case(dev)
    worst = _compare(ref, got)
    c_cpu, c_gpu = _counters(st_c), _counters(st_g)
    if c_cpu != c_gpu:
        raise AssertionError(f"engine counters differ: CPU {c_cpu}, GPU {c_gpu}")
    if min(c_gpu["retries"], c_gpu["copied_specs"], c_gpu["truncated_tiles"]) == 0 \
            or set(c_gpu["by_pass"]) != {"narrow", "wide"}:
        raise AssertionError(f"a mechanism did not run on the GPU: {c_gpu}")
    if n1 == 0 or n2 == 0:
        raise AssertionError(f"GPU engine bypassed a kernel: K1 {n1}, K2 {n2} launches")
    n_keys = sum(len(d) for d in got.values())
    say("engine", f"{len(uni.halo_renclose)} halos, {len(uni.pos)} particles, "
        f"{len(got)} groups, {n_keys} keys: GPU == CPU within tolerance (largest "
        f"scaled error {worst}); counters equal {c_gpu}; launches K1 {n1}, K2 {n2}")


def hydro_engine_case(where, parameter_file=None, neutrinos=False, tile_caps=None,
                      enclose_scale=0.3):
    """Phase 5h's run on one device: the CPU hydro test's mock (two
    satellites, they and every fourth halo satellites, every third input
    radius shrunk x0.002, EncloseRadius understated x0.3) with the
    default hydro list, or a shipped parameter file's (phase 5p); with
    ``neutrinos``, the mock gains a PartType6 population and the list
    keeps its SO groups (phase 5n); ``enclose_scale`` replaces the x0.3
    (phase 5c)."""
    uni = build_mock_universe(**HYDRO_SMALL)
    if neutrinos:
        uni = add_neutrinos(uni, NU_RATIO, NU_SEED)
    ctx, chunk, args, specs = _hydro_inputs(uni, torch.device(where), parameter_file)
    if neutrinos:
        specs = [s for s in specs if s.kind == "SO"]
    H = uni.n_halos
    args["is_central"] = (np.arange(H) % 4 != 0) & (np.asarray(uni.halo_rank) == 0)
    args["search_radius_phys"] = args["search_radius_phys"] * np.where(
        np.arange(H) % 3 == 0, 0.002, 1.0
    )
    args["enclose_radius_phys"] = args["enclose_radius_phys"] * enclose_scale
    rg.launches = il.launches = 0
    hs.k2_launches_by_config.clear()
    eng = HaloEngine(ctx, chunk, specs, where, tile_caps=tile_caps)
    res = eng.process(**args)
    return uni, res, eng.stats, dict(hs.k2_launches_by_config)


#: phase 5c's tile plans, as (rows, halos) per bucket: CAPACITY_ROW_FACTOR
#: times the default row budget with the default halo cap (each round of
#: these mocks in one bucket, padded to its largest halo's rows), and the
#: default row budget with one halo per bucket (padded to its own rows)
CAPACITY_ROW_FACTOR = 16
#: phase 5c's runs: (name, engine case, its mock, keywords)
CAPACITY_CASES = (
    ("DMO list", "engine", ENGINE_MOCK, {}),
    ("DMO list at the catalogue's EncloseRadius", "engine", ENGINE_MOCK,
     {"enclose_scale": 1.0}),
    ("hydro list", "hydro", HYDRO_SMALL, {}),
    ("hydro list at the catalogue's EncloseRadius", "hydro", HYDRO_SMALL,
     {"enclose_scale": 1.0}),
)
#: the groups and keys phase 5c allows to differ between the two plans,
#: by run (a name ending in "/" stands for every key of its group), each
#: named with its cause in PERF.md: phases 5 and 5h understate every
#: EncloseRadius x0.3, and the engine decides per tile, from the largest
#: EncloseRadius of its halos, whether a wide aperture copies the
#: next-smaller one, so a halo whose bound particles reach past the copy
#: source is copied in one plan and computed in the other (the JAX
#: engine decides the same way); two SO/5xR500_crit iterative inertia
#: tensors of the DMO run move with the plan too.  At the catalogue's
#: EncloseRadius every key must be bit-equal.
_WIDE_EXCLUSIVE = tuple(f"ExclusiveSphere/{r}kpc/" for r in (300, 500, 1000, 3000))
CAPACITY_EXCEPTIONS = {
    "DMO list": _WIDE_EXCLUSIVE + ("SO/5xR500_crit/DarkMatterInertiaTensor",
                                   "SO/5xR500_crit/TotalInertiaTensor"),
    "hydro list": _WIDE_EXCLUSIVE,
}


class CapacityLog:
    """Each halo's largest padded row capacity per particle type over the
    bucket calls of an engine run, read from the context every
    ``_process_bucket`` call is given."""

    def __init__(self):
        self.cap = {}

    def __enter__(self):
        self._fn = engine_mod._process_bucket

        def logged(ctx, *a, **kw):
            for i in a[7].tolist():  # the bucket's catalogue indices
                old = self.cap.get(i, (0,) * len(ctx.capacities))
                self.cap[i] = tuple(max(x, y) for x, y in zip(old, ctx.capacities))
            return self._fn(ctx, *a, **kw)

        engine_mod._process_bucket = logged
        return self

    def __exit__(self, *exc):
        engine_mod._process_bucket = self._fn


def bit_differences(a, b):
    """The group/key names whose arrays are not bit-equal (dtype, shape
    and bytes)."""
    bad = []
    for group in a:
        for key in a[group]:
            x, y = np.asarray(a[group][key]), np.asarray(b[group][key])
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                bad.append(f"{group}/{key}")
    return bad


def _allowed(key, names):
    return any(key == n or (n.endswith("/") and key.startswith(n)) for n in names)


def phase_capacity(dev):
    """Phase 5c: each run of CAPACITY_CASES on the GPU under the two tile
    plans: each halo's row capacity in the two, and every key bit-equal
    but the run's named exceptions."""
    for tag, kind, mock, kw in CAPACITY_CASES:
        case, make_inputs = ((engine_case, _bench_inputs) if kind == "engine"
                             else (hydro_engine_case, _hydro_inputs))
        ctx, chunk, _, specs = make_inputs(build_mock_universe(**mock), dev)
        budget = engine_mod.row_budget(chunk, specs, ctx)
        plans = ((CAPACITY_ROW_FACTOR * budget, engine_mod.MAX_BATCH), (budget, 1))
        runs = []
        for tile_caps in plans:
            with CapacityLog() as log:
                uni, res, stats = case(dev, tile_caps=tile_caps, **kw)[:3]
            torch.cuda.synchronize()
            runs.append((res, stats, log.cap))
        (ref, st_a, cap_a), (got, st_b, cap_b) = runs
        # per halo, the particle type whose padding the plans changed most
        ratio = np.array([max(x / y for x, y in zip(cap_a[i], cap_b[i]) if y)
                          for i in cap_a if i in cap_b and i >= 0])
        if ratio.size == 0 or ratio.max() <= 1.0:
            raise AssertionError(f"capacity {tag}: the two plans padded every halo alike")
        names = CAPACITY_EXCEPTIONS.get(tag, ())
        bad = bit_differences(ref, got)
        unexplained = [k for k in bad if not _allowed(k, names)]
        n_keys = sum(len(d) for d in ref.values())
        say("capacity", f"{tag}: {uni.n_halos} halos, {n_keys} keys; bucket calls "
            f"{st_a.n_bucket_calls} (tile caps {plans[0]}) and {st_b.n_bucket_calls} "
            f"({plans[1]}); each halo's largest row capacity of a particle type, first "
            f"plan over second, for the type it moves most: min "
            f"{ratio.min():.2f}, median {np.median(ratio):.2f}, max {ratio.max():.2f}, "
            f"2x or more for {int((ratio >= 2).sum())} of {ratio.size} halos; keys not "
            f"bit-equal: {len(bad)} {bad[:20]}; of them allowed by name "
            f"{len(bad) - len(unexplained)} ({list(names)})")
        if unexplained:
            raise AssertionError(f"capacity {tag}: {len(unexplained)} keys depend on the "
                                 f"bucket capacity: {unexplained[:20]}")


def phase_neutrinos(dev):
    """Phase 5n: phase 5h's mock with neutrinos and FLAMINGO's SO groups,
    GPU against CPU, K1 launched for PartType6."""
    uni, ref, st_c, _ = hydro_engine_case("cpu", "FLAMINGO", neutrinos=True)
    _, got, st_g, _ = hydro_engine_case(dev, "FLAMINGO", neutrinos=True)
    worst = _compare(ref, got)
    c_cpu, c_gpu = _counters(st_c), _counters(st_g)
    if c_cpu != c_gpu:
        raise AssertionError(f"neutrinos: engine counters differ: CPU {c_cpu}, GPU {c_gpu}")
    k1_by = dict(sorted(st_g.k1_launches_by_ptype.items()))
    if k1_by.get("PartType6", 0) == 0:
        raise AssertionError(f"neutrinos: K1 did not launch for PartType6: {k1_by}")
    nu = uni.extra_ptypes["PartType6"]
    so = got["SO/200_crit"]
    n_raw_ne_weighted = int(np.sum(np.abs(so["Mnu"] - so["MnuNS"]) > 0))
    say("neutrinos", f"{uni.n_halos} halos, {len(nu['Weights'])} neutrinos "
        f"({float(np.mean(nu['Weights'] < 0)):.3f} of weights negative), {len(got)} SO "
        f"groups, {sum(len(d) for d in got.values())} keys: GPU == CPU within tolerance "
        f"(largest scaled error {worst}); counters equal {c_gpu}; K1 launches by type "
        f"{k1_by}; SO/200_crit halos whose raw and weighted neutrino masses differ: "
        f"{n_raw_ne_weighted}")


def phase_engine_hydro(dev):
    uni, ref, st_c, _ = hydro_engine_case("cpu")
    _, got, st_g, k2_by = hydro_engine_case(dev)
    worst = _compare(ref, got)
    c_cpu, c_gpu = _counters(st_c), _counters(st_g)
    if c_cpu != c_gpu:
        raise AssertionError(f"hydro engine counters differ: CPU {c_cpu}, GPU {c_gpu}")
    if min(c_gpu["bucket_calls"], c_gpu["copied_specs"]) == 0:
        raise AssertionError(f"a hydro mechanism did not run on the GPU: {c_gpu}")
    k1_by = dict(sorted(st_g.k1_launches_by_ptype.items()))
    if len(k1_by) != 4 or min(k1_by.values()) == 0:
        raise AssertionError(f"K1 did not launch for every particle type: {k1_by}")
    if min(k2_by.get(c, 0) for c in ("gas", "star", "lum")) == 0:
        raise AssertionError(f"K2 did not launch for gas, star and luminosity configs: {k2_by}")
    n_keys = sum(len(d) for d in got.values())
    say("engine-hydro", f"{uni.n_halos} halos, {len(got)} groups, {n_keys} keys: GPU == "
        f"CPU within tolerance (largest scaled error {worst}); counters equal {c_gpu}; "
        f"K1 launches by type {k1_by}; K2 launches by config {dict(sorted(k2_by.items()))}")


#: phase 5p's every-key run: the families whose K2 launches it must see
#: (the first group of each): the four core-excised SOs, and the two
#: property-sized spheres
EVERY_KEY_K2_GROUPS = (
    "SO/200_crit", "ExclusiveSphere/2xHalfMassRadiusStars",
    "InclusiveSphere/2xHalfMassRadiusStars",
)


def every_key_specs(bn98):
    """COLIBRE_THERMAL's bound subhalo, SOs and property-sized apertures
    with no property switched off, and a 50 kpc fixed-radius SO (as
    tests/test_torch_engine_excised.py runs them against the JAX engine)."""
    with open(parameter_file_path("COLIBRE_THERMAL")) as f:
        raw = json.load(f)
    for section in ("SubhaloProperties", "SOProperties", "ApertureProperties",
                    "ProjectedApertureProperties"):
        raw[section].pop("properties", None)
    raw["SOProperties"]["variations"]["50_kpc"] = {"type": "physical", "radius_in_kpc": 50.0}
    specs = build_specs(ParameterFile(parameter_dictionary=raw), False, bn98)
    return [s for s in specs if s.kind in ("bound", "SO") or s.radius_property is not None]


def uses_k2(specs):
    """Whether a spec list runs the inertia loop: an iterative 3D inertia
    tensor (projected ones and non-iterative ones take plain PyTorch)."""
    return any("InertiaTensor" in k and "Noniterative" not in k
               for s in specs if s.kind != "projected" for k in s.keys)


def phase_engine_params(dev):
    for name in ("COLIBRE_THERMAL", "FLAMINGO", "every-key"):
        uni, ref, st_c, _ = hydro_engine_case("cpu", name)
        _, got, st_g, k2_by = hydro_engine_case(dev, name)
        worst = _compare(ref, got)
        c_cpu, c_gpu = _counters(st_c), _counters(st_g)
        if c_cpu != c_gpu:
            raise AssertionError(f"{name} engine counters differ: CPU {c_cpu}, GPU {c_gpu}")
        k1_by = dict(sorted(st_g.k1_launches_by_ptype.items()))
        if len(k1_by) != 4 or min(k1_by.values()) == 0:
            raise AssertionError(f"{name}: K1 did not launch for every particle type: {k1_by}")
        k2_groups = dict(sorted(st_g.k2_launches_by_group.items()))
        want = EVERY_KEY_K2_GROUPS if name == "every-key" else ()
        if want and min(k2_groups.get(g, 0) for g in want) == 0:
            raise AssertionError(f"{name}: K2 did not launch for {want}: {k2_groups}")
        n_keys = sum(len(d) for d in got.values())
        say("engine-params", f"{name}: {uni.n_halos} halos, {len(got)} groups, {n_keys} "
            f"keys: GPU == CPU within tolerance (largest scaled error {worst}); counters "
            f"equal {c_gpu}; K1 launches by type {k1_by}; K2 launches by family {k2_groups}")


class PathCheck:
    """Holds every K1, K2 and K3 call of one engine pass against its
    plain version on the same inputs, right after the call (K3 against
    ``x.double().sum(dim)``: ``k3_against_float64``), and records the
    shapes the path gave each kernel and the devices it launched on.  It
    wraps the names the engine calls the wrappers through
    (``particle_sum`` calls ``reductions._kernel_sum`` by its module's
    name), so each launch counter still counts only the engine's own
    launches; the plain versions count none.  The engine's worker threads
    call it at once."""

    def __init__(self):
        self.k1 = dict(calls=0, max_abs_err=0.0, shapes={}, devices={})
        self.k2 = dict(calls=0, max_abs_err=0.0, shapes={}, devices={})
        self.k3 = dict(calls=0, ties=0, shapes={}, devices={})
        self._lock = threading.Lock()

    def _note(self, rec, shape, err, device, ties=0):
        """One checked call: K1's and K2's max abs error (``err``), K3's
        rounding ties (``err`` None)."""
        with self._lock:
            rec["calls"] += 1
            if err is None:
                rec["ties"] += ties
            else:
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["shapes"][shape] = rec["shapes"].get(shape, 0) + 1
            rec["devices"][str(device)] = rec["devices"].get(str(device), 0) + 1

    def _k1(self, packed, table, S, capacity):
        n = rg.launches_here()
        got = self._range_gather(packed, table, S, capacity)
        if rg.launches_here() == n:  # nothing to gather, no launch
            return got
        ref = rg.range_gather_blocks_plain(packed, table, S, capacity)
        # bit for bit: the store's padding columns hold NaN
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K1 differs from its plain version at {tuple(got.shape)}")
        err = (got - ref).nan_to_num(0.0).abs().max().item() if got.numel() else 0.0
        self._note(self.k1, "B={} capacity={} F={}".format(*got.shape), err, got.device)
        return got

    def _k2(self, *args, **kw):
        by_g = il.cluster_launches_here()
        got = self._inertia_loop(*args, **kw)
        # the cluster size this thread's launch counted under, if any
        G = [g for g, n in il.cluster_launches_here().items() if n != by_g.get(g, 0)]
        if not G:  # no halos, no launch
            return got
        (G,) = G
        ref = il.inertia_loop_plain(*args)
        (B, _, K), C = args[0].shape, args[3].shape[1]
        self._note(self.k2, f"B={B} K={K} C={C} G={G}", k2_err(f"B={B} K={K}", got, ref),
                   got.device)
        return got

    def _k3(self, x, dim, mask, out_dtype):
        n = red.launches_here()
        got = self._kernel_sum(x, dim, mask, out_dtype)
        if red.launches_here() == n:  # no rows, no launch
            return got
        shape = (f"{tuple(x.shape)} dim={dim % x.dim()} {str(x.dtype)[6:]}->"
                 f"{str(out_dtype)[6:]}{' masked' if mask is not None else ''}")
        off, ties = k3_against_float64(got, x, dim, mask)
        if off != ties:
            raise AssertionError(f"K3 at {shape}: {off - ties} elements off the float64 path "
                                 f"beyond a rounding tie")
        self._note(self.k3, shape, None, got.device, ties)
        return got

    def __enter__(self):
        self._range_gather, self._inertia_loop = rg.range_gather_blocks, inertia_ops.inertia_loop
        self._kernel_sum = red._kernel_sum
        rg.range_gather_blocks, inertia_ops.inertia_loop = self._k1, self._k2
        red._kernel_sum = self._k3
        return self

    def __exit__(self, *exc):
        rg.range_gather_blocks, inertia_ops.inertia_loop = self._range_gather, self._inertia_loop
        red._kernel_sum = self._kernel_sum


def drive_path(tag, H, inputs, dev, timed=TIMED_PASSES):
    """One path's inputs (context, staged chunk, process() arguments, spec
    list) through the engine: a warm pass, then ``timed`` timed passes,
    each with every launch counter set to 0 just before it and read just
    after, then one checked pass (PathCheck).  Returns the last timed
    pass's results and counts, and the checks."""
    ctx, chunk, args, specs = inputs
    n_keys = sum(len(s.keys) for s in specs)
    say(tag, f"spec list: {len(specs)} calculations, {n_keys} keys")
    t0 = time.perf_counter()
    HaloEngine(ctx, chunk, specs, dev).process(**args)  # warm pass
    torch.cuda.synchronize()
    say(tag, f"warm pass {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(timed):
        engine = HaloEngine(ctx, chunk, specs, dev)
        torch.cuda.synchronize()
        rg.launches = il.launches = red.launches = 0
        il.cluster_launches.clear()
        hs.k2_launches_by_config.clear()
        t0 = time.perf_counter()
        res = engine.process(**args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"range_gather": rg.launches, "inertia_loop": il.launches}
        k3 = {"particle_sum": red.launches}
        if not k3["particle_sum"]:
            raise AssertionError(f"{tag} path: no particle sum launched K3")
        by_g = dict(sorted(il.cluster_launches.items()))
        k2_by_config = dict(sorted(hs.k2_launches_by_config.items()))
        # every kernel the list runs launched (K2 only with iterative
        # inertia keys), and none it does not run
        if launches["range_gather"] == 0 or (launches["inertia_loop"] > 0) != uses_k2(specs):
            raise AssertionError(f"{tag} path bypassed a kernel: {launches}")
        rates.append(H / dt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1_by_ptype = dict(sorted(engine.stats.k1_launches_by_ptype.items()))
    k2_by_family = dict(sorted(engine.stats.k2_launches_by_group.items()))

    if sum(len(d) for d in res.values()) != n_keys:
        raise AssertionError(f"{tag}: {sum(len(d) for d in res.values())} keys, not {n_keys}")
    for group, d in res.items():
        for key, arr in d.items():
            if arr.shape[0] != H or not np.isfinite(np.asarray(arr, np.float64)).all():
                raise AssertionError(f"{tag} {group}/{key}: shape {arr.shape} or non-finite")
    if not (res["SO/200_crit"]["r"][args["is_central"]] > 0).all():
        raise AssertionError(f"{tag} SO/200_crit/r not positive for every central")

    with PathCheck() as check:
        HaloEngine(ctx, chunk, specs, dev).process(**args)
        torch.cuda.synchronize()
    if (check.k1["calls"], check.k2["calls"], check.k3["calls"]) != (
            *launches.values(), k3["particle_sum"]):
        raise AssertionError(f"{tag} checked pass made {check.k1['calls']} K1, "
                             f"{check.k2['calls']} K2 and {check.k3['calls']} K3 calls, the "
                             f"timed pass {launches}, {k3}")
    by_cg = {}
    for shape, n in check.k2["shapes"].items():
        cg = " ".join(shape.split()[2:])
        by_cg[cg] = by_cg.get(cg, 0) + n
    say(tag, f"{H} halos: halos/s over {timed} timed passes median "
        f"{np.median(rates):.2f} (min {min(rates):.2f}, max {max(rates):.2f}; "
        f"{', '.join(f'{r:.2f}' for r in rates)}); {_counters(engine.stats)}; "
        f"peak device memory {peak:.2f} GiB; launches per pass {launches}, K1 "
        f"launches by type {k1_by_ptype}, K2 launches by config {k2_by_config}, "
        f"by family {k2_by_family}, by G {by_g}, by C and G {dict(sorted(by_cg.items()))}; "
        f"K3 sums {k3['particle_sum']}")
    say(tag, f"checked pass, every call against its plain version: K1 "
        f"bit-equal at {check.k1['shapes']}; K2 within rtol {K2_RTOL} at "
        f"{check.k2['shapes']} (max abs err {check.k2['max_abs_err']:.3e}); {k3_line(check.k3)}")
    return dict(res=res, launches=launches, k3=k3, by_g=by_g, k1_by_ptype=k1_by_ptype,
                k2_by_config=k2_by_config, k2_by_family=k2_by_family, inputs=inputs,
                check={"range_gather": check.k1, "inertia_loop": check.k2,
                       "particle_sum": check.k3})


def k3_line(rec):
    """One line for a checked pass's K3 calls: how many, at how many
    layouts (the five largest named), and the rounding ties."""
    big = sorted(rec["shapes"], key=lambda s: -math.prod(
        int(n) for n in re.findall(r"\d+", s.split(")")[0])))[:5]
    return (f"K3 {rec['calls']} sums at {len(rec['shapes'])} layouts (largest {big}) equal "
            f"to the float64 path but {rec['ties']} float32 rounding ties, float64 within "
            f"2 K u sum|x|")


def phase_main(dev):
    t0 = time.perf_counter()
    uni = build_mock_universe(**BENCH)
    t1 = time.perf_counter()
    say("main", f"universe {len(uni.pos)} particles, {uni.n_halos} halos in "
        f"{t1 - t0:.1f} s")
    run = drive_path("main", uni.n_halos, _bench_inputs(uni, dev), dev)
    if not (run["res"]["BoundSubhalo"]["Mtot"] > 0).all():
        raise AssertionError("BoundSubhalo/Mtot not positive for every halo")
    return run, uni


def phase_giant(dev):
    """The giant-halo path with the engine slice's small spec set (2
    calculations, 12 keys; the full list at this size would not fit the
    run's time limit) and no EncloseRadius."""
    t0 = time.perf_counter()
    uni = build_mock_universe(**GIANT)
    n_big = max(len(ids) for ids in uni.bound_ids)
    say("giant", f"universe {len(uni.pos)} particles, {uni.n_halos} halos, biggest "
        f"{n_big} particles; built in {time.perf_counter() - t0:.1f} s")
    ctx, chunk, args, _ = _bench_inputs(uni, dev)
    del args["enclose_radius_phys"]
    run = drive_path("giant", uni.n_halos, (ctx, chunk, args, slice_specs()), dev,
                     GIANT_TIMED_PASSES)
    ndm = run["res"]["BoundSubhalo"]["Ndm"]
    want = np.array([len(ids) for ids in uni.bound_ids])
    if not np.array_equal(ndm, want):
        raise AssertionError(f"giant BoundSubhalo/Ndm {ndm.tolist()} != {want.tolist()}")
    if not any(g > 1 for g in run["by_g"]):
        raise AssertionError(f"giant path ran K2 in no cluster: by G {run['by_g']}")
    return run


def phase_hydro(dev):
    """The hydro path: bench.py::bench_hydro's universe built in memory,
    the full default hydro list (38 calculations, 4729 keys).  Returns the
    run and the universe."""
    t0 = time.perf_counter()
    uni = build_mock_universe(**HYDRO)
    n_part = len(uni.pos) + sum(len(f["Coordinates"]) for f in uni.extra_ptypes.values())
    t1 = time.perf_counter()
    inputs = _hydro_inputs(uni, dev)
    torch.cuda.synchronize()
    say("hydro", f"universe {n_part} particles ({len(uni.pos)} DM, "
        + ", ".join(f"{pt} {len(f['Coordinates'])}" for pt, f in uni.extra_ptypes.items())
        + f"), {uni.n_halos} halos, built in {t1 - t0:.1f} s, staged in "
        f"{time.perf_counter() - t1:.1f} s; row widths "
        f"{ {pt: c.row_width for pt, c in inputs[1].ptypes.items()} }")
    run = drive_path("hydro", uni.n_halos, inputs, dev, HYDRO_TIMED_PASSES)
    sub = run["res"]["BoundSubhalo"]
    for key in ("Mtot", "Mgas", "Mstar"):
        if not (sub[key] > 0).all():
            raise AssertionError(f"hydro BoundSubhalo/{key} not positive for every halo")
    if len(run["k1_by_ptype"]) != 4 or min(run["k1_by_ptype"].values()) == 0:
        raise AssertionError(f"hydro path: K1 missed a particle type {run['k1_by_ptype']}")
    if min(run["k2_by_config"].get(c, 0) for c in ("gas", "star", "lum")) == 0:
        raise AssertionError(f"hydro path: K2 missed gas/star/luminosity configs "
                             f"{run['k2_by_config']}")
    return run, uni


def phase_colibre(dev, uni):
    """The COLIBRE path: the hydro path's universe with the COLIBRE_THERMAL
    parameter file's list (50 calculations, 4114 keys) and context."""
    t0 = time.perf_counter()
    inputs = _hydro_inputs(uni, dev, "COLIBRE_THERMAL")
    torch.cuda.synchronize()
    say("colibre", f"staged in {time.perf_counter() - t0:.1f} s; row widths "
        f"{ {pt: c.row_width for pt, c in inputs[1].ptypes.items()} }")
    run = drive_path("colibre", uni.n_halos, inputs, dev, HYDRO_TIMED_PASSES)
    res = run["res"]
    for key in ("Mtot", "Mgas", "Mstar"):
        if not (res["BoundSubhalo"][key] > 0).all():
            raise AssertionError(f"colibre BoundSubhalo/{key} not positive for every halo")
    # the sphere of twice the stellar half-mass radius holds no more than
    # the bound stars, and more than half of them in most halos (with few
    # stars the interpolated half-mass radius can fall inside the first)
    m_bound = res["BoundSubhalo"]["Mstar"]
    m_ap = res["ExclusiveSphere/2xHalfMassRadiusStars"]["Mstar"]
    over_half = float(np.mean(m_ap > 0.5 * m_bound))
    if (m_ap > m_bound * (1 + 1e-6)).any() or over_half < 0.5:
        raise AssertionError(f"colibre ExclusiveSphere/2xHalfMassRadiusStars/Mstar: "
                             f"{over_half:.3f} of halos over half the bound stars")
    say("colibre", f"{over_half:.4f} of halos hold more than half their bound stellar "
        f"mass within twice its half-mass radius")
    if len(run["k1_by_ptype"]) != 4 or min(run["k1_by_ptype"].values()) == 0:
        raise AssertionError(f"colibre path: K1 missed a particle type {run['k1_by_ptype']}")
    return run


def phase_colibre_every_key(dev, uni):
    """The COLIBRE every-key path: ``every_key_specs`` with COLIBRE_THERMAL's
    context on the hydro path's universe."""
    run = drive_path("colibre-every-key", uni.n_halos, _hydro_inputs(uni, dev, "every-key"),
                     dev, HYDRO_TIMED_PASSES)
    missing = [g for g in EVERY_KEY_K2_GROUPS if run["k2_by_family"].get(g, 0) == 0]
    if missing:
        raise AssertionError(f"colibre every-key path: K2 missed {missing}: "
                             f"{run['k2_by_family']}")
    return run


def entry_inputs(uni, dmo, parameter_file=None):
    """The entry's in-memory inputs for a mock universe: its metadata and
    HBTplus catalogue as the JAX readers read them back from its files
    (``mock_metadata``, ``mock_catalogue``), the host fields of
    ``entry_plan``'s types and list, and the parameter file (a shipped
    one by name, or none: the defaults)."""
    meta = mock_metadata(uni)
    params = None if parameter_file is None else ParameterFile(
        parameter_file_path(parameter_file))
    ptypes, specs = entry_plan(meta, dmo, params)
    host = mock_fields(uni, specs, meta, ptypes, age_table(meta))
    return dict(meta=meta, cat=mock_catalogue(uni), host=host, specs=specs, params=params,
                dmo=dmo)


def run_entry(inputs, device, **kw):
    i = inputs
    return build_catalogue(i["meta"], i["cat"], i["host"], i["specs"], i["params"], i["dmo"],
                           device=device, **kw)


def phase_entry(dev):
    """Phase 5e: ``build_catalogue`` on the GPU against the CPU, with the
    DMO list on phase 5's mock and FLAMINGO's file on phase 5h's."""
    for tag, mock, dmo, pf in (("DMO list", ENGINE_MOCK, True, None),
                               ("FLAMINGO", HYDRO_SMALL, False, "FLAMINGO")):
        uni = build_mock_universe(**mock)
        ref = run_entry(entry_inputs(uni, dmo, pf), "cpu")
        rg.launches = il.launches = 0
        got = run_entry(entry_inputs(uni, dmo, pf), dev)
        n1, n2 = rg.launches, il.launches
        diffs = catalogue_differences(ref.catalogue, got.catalogue)
        if diffs:
            raise AssertionError(f"entry {tag}: GPU catalogue differs from CPU: {diffs[:10]}")
        if not np.array_equal(ref.order, got.order):
            raise AssertionError(f"entry {tag}: sort orders differ")
        if n1 == 0 or n2 == 0:
            raise AssertionError(f"entry {tag}: GPU run bypassed a kernel: K1 {n1}, K2 {n2}")
        cat = got.catalogue
        say("entry", f"{tag}: {cat.n_halos} halos, {len(cat.datasets)} datasets, "
            f"{len(cat.groups)} groups: GPU == CPU (names, dtypes, shapes, attributes; "
            f"exact sort, passthrough, SOAP/* and integers; floats within tolerance); "
            f"counters {_counters(got.stats)}; launches K1 {n1}, K2 {n2}")


def drive_entry(tag, inputs, dev, timed, **kw):
    """One path through the entry's in-memory half (``kw``: the chunk
    loop's options): a warm pass, then ``timed`` timed passes (each with
    the launch counters set to 0 just before it and read just after),
    then a checked pass (PathCheck).  Reports halos/s over the whole
    entry and its seconds before, in and after the engine; returns each
    timed pass's device memory before it and its chunk records."""
    specs, H = inputs["specs"], inputs["cat"].nr_halos
    say(tag, f"spec list: {len(specs)} calculations, {sum(len(s.keys) for s in specs)} keys; "
        f"{H} halos; {sum(len(p) for p, _ in inputs['host'].values())} particles; "
        f"options {kw}")
    t0 = time.perf_counter()
    run_entry(inputs, dev, **kw)
    torch.cuda.synchronize()
    say(tag, f"warm pass {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    rates, parts, passes = [], [], []
    for _ in range(timed):
        torch.cuda.synchronize()
        baseline = torch.cuda.memory_allocated()
        rg.launches = il.launches = red.launches = 0
        il.cluster_launches.clear()
        hs.k2_launches_by_config.clear()
        t0 = time.perf_counter()
        out = run_entry(inputs, dev, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        passes.append((baseline, out.chunks))
        launches = {"range_gather": rg.launches, "inertia_loop": il.launches}
        k3 = {"particle_sum": red.launches}
        if launches["range_gather"] == 0 or (launches["inertia_loop"] > 0) != uses_k2(specs) \
                or not k3["particle_sum"]:
            raise AssertionError(f"{tag} path bypassed a kernel: {launches}, {k3}")
        rates.append(H / dt)
        parts.append((out.prep_seconds, out.stage_seconds, out.engine_seconds, out.post_seconds))
    peak = torch.cuda.max_memory_allocated() / 2**30
    cat = out.catalogue
    if cat.n_halos != H:
        raise AssertionError(f"{tag}: {cat.n_halos} halos in the catalogue, not {H}")
    for path, ds in cat.datasets.items():
        data = np.asarray(ds.data)
        if path.split("/")[0] != "Cells" and (data.shape[0] != H or not np.isfinite(
                data.astype(np.float64)).all()):
            raise AssertionError(f"{tag} {path}: shape {data.shape} or non-finite")
    with PathCheck() as check:
        run_entry(inputs, dev, **kw)
        torch.cuda.synchronize()
    if (check.k1["calls"], check.k2["calls"], check.k3["calls"]) != (
            *launches.values(), k3["particle_sum"]):
        raise AssertionError(f"{tag} checked pass made {check.k1['calls']} K1, "
                             f"{check.k2['calls']} K2 and {check.k3['calls']} K3 calls, the "
                             f"timed pass {launches}, {k3}")
    med = np.median(np.array(parts), 0)
    say(tag, f"{H} halos: entry halos/s over {timed} timed passes median "
        f"{np.median(rates):.2f} (min {min(rates):.2f}, max {max(rates):.2f}; "
        f"{', '.join(f'{r:.2f}' for r in rates)}); median seconds: before the engine "
        f"{med[0]:.4f}, staging {med[1]:.4f}, engine {med[2]:.4f}, after it (filters, sort, "
        f"derived columns, catalogue) {med[3]:.4f}, post-processing share "
        f"{med[3] / med.sum():.4f}; {_counters(out.stats)}; peak device memory {peak:.2f} "
        f"GiB; launches per pass {launches}, K1 by type "
        f"{dict(sorted(out.stats.k1_launches_by_ptype.items()))}, K2 by family "
        f"{dict(sorted(out.stats.k2_launches_by_group.items()))}; {len(cat.datasets)} datasets")
    say(tag, f"checked pass, every call against its plain version: K1 bit-equal at "
        f"{check.k1['shapes']}; K2 within rtol {K2_RTOL} at {check.k2['shapes']} (max abs "
        f"err {check.k2['max_abs_err']:.3e}); {k3_line(check.k3)}")
    return dict(out=out, launches=launches, inputs=inputs, passes=passes, peak=peak,
                rates=rates, check={"range_gather": check.k1, "inertia_loop": check.k2,
                                    "particle_sum": check.k3})


def _sorted_cells(cat, meta):
    """The top-level cell of each catalogue row (the sort's first key)."""
    n = int(meta.dimension[0])
    centres = np.mod(cat.datasets["InputHalos/HaloCentre"].data, meta.boxsize)
    ijk = np.clip(np.floor(centres / (meta.boxsize / n)).astype(np.int64), 0, n - 1)
    return (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]


def phase_entry_main(dev, uni):
    """Phase 11: the main path's universe through the entry with the
    default DMO list."""
    t0 = time.perf_counter()
    inputs = entry_inputs(uni, True)
    say("main-entry", f"inputs built in {time.perf_counter() - t0:.1f} s")
    run = drive_entry("main-entry", inputs, dev, TIMED_PASSES)
    cat = run["out"].catalogue
    idx = cat.datasets["InputHalos/HaloCatalogueIndex"].data
    ndm = cat.datasets["BoundSubhalo/NumberOfDarkMatterParticles"].data
    if not np.array_equal(ndm, np.asarray(uni.halo_nbound)[idx]):
        raise AssertionError("main-entry BoundSubhalo/NumberOfDarkMatterParticles != Nbound")
    if not (np.diff(_sorted_cells(cat, inputs["meta"])) >= 0).all():
        raise AssertionError("main-entry catalogue not in cell order")
    central = cat.datasets["InputHalos/IsCentral"].data == 1
    if not (cat.datasets["SO/200_crit/SORadius"].data[central] > 0).all():
        raise AssertionError("main-entry SO/200_crit/SORadius not positive for every central")
    return run


def phase_entry_flamingo(dev, uni):
    """Phase 12: the hydro path's universe through the entry with
    FLAMINGO's list and context (its 5 cMpc read radius floor, category
    filters at 100 particles, disabled keys dropped, the reduced-snapshot
    flag, K2 for the bound subhalo)."""
    t0 = time.perf_counter()
    inputs = entry_inputs(uni, False, "FLAMINGO")
    say("flamingo-entry", f"inputs built in {time.perf_counter() - t0:.1f} s")
    run = drive_entry("flamingo-entry", inputs, dev, HYDRO_TIMED_PASSES)
    out = run["out"]
    cat = out.catalogue
    flag = cat.datasets["SOAP/IncludedInReducedSnapshot"].data
    masked = [p for p, d in cat.datasets.items() if d.attrs.get("Masked") is True]
    if not masked or any(cat.datasets[p].attrs["Mask Threshold"] != 100 for p in masked):
        raise AssertionError("flamingo-entry: no dataset masked at 100 particles")
    if not set(np.unique(flag)) <= {0, 1}:
        raise AssertionError("flamingo-entry: IncludedInReducedSnapshot not a flag")
    if len(out.stats.k1_launches_by_ptype) != 4 or \
            out.stats.k2_launches_by_group.get("BoundSubhalo", 0) == 0:
        raise AssertionError(f"flamingo-entry: K1 by type {out.stats.k1_launches_by_ptype}, "
                             f"K2 by family {out.stats.k2_launches_by_group}")
    if not (cat.datasets["BoundSubhalo/TotalMass"].data > 0).all():
        raise AssertionError("flamingo-entry BoundSubhalo/TotalMass not positive")
    say("flamingo-entry", f"{len(masked)} datasets masked at 100 particles; "
        f"{int(flag.sum())} of {cat.n_halos} halos in the reduced snapshot")
    return run


#: the chunked entries' Peano–Hilbert chunks
ENTRY_CHUNKS = 4
#: the timing check's chunks (phase 13t)
TIMING_CHUNKS = 3


def check_prestage(tag, inputs, dev):
    """One chunk (the second) staged by ``chunks.prestage`` on a side
    stream in another thread, against the same chunk staged on the main
    stream: torch.equal for every tensor (floats as their bits)."""
    meta, cat, specs = inputs["meta"], inputs["cat"], inputs["specs"]
    chunk_of = peano_decomposition(np.mod(cat.cofp, meta.boxsize), meta.boxsize, ENTRY_CHUNKS)
    rows = np.flatnonzero(chunk_of == 1)
    host = chunks.memory_reader(meta, cat, inputs["host"], specs)(rows)
    serial = chunks.stage_chunk(host, meta.boxsize, dev)
    with ThreadPoolExecutor(1) as pool:
        pre, ready = pool.submit(chunks.prestage, host, meta.boxsize, dev).result()
    chunks.adopt(pre, ready, dev)
    for pt, a in serial.ptypes.items():
        b = pre.ptypes[pt]
        if (a.spec, a.n, a.row_width, a.cols_f, a.cols_i) != (
                b.spec, b.n, b.row_width, b.cols_f, b.cols_i):
            raise AssertionError(f"{tag}: prestaged {pt} layout differs from serial staging")
    for x, y in zip(chunks.chunk_tensors(serial), chunks.chunk_tensors(pre)):
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: a prestaged tensor differs from serial staging")
    n = sum(len(p) for p, _ in host.values())
    say(tag, f"chunk 1 ({len(rows)} halos, {n} particles, "
        f"{chunks.store_bytes(pre) / 2**30:.3f} GiB): prestaged store on a side stream in "
        f"another thread torch.equal to the main stream's serial staging, every tensor")


def phase_entry_chunked(tag, dev, one, timed, serial_pass=True):
    """Phases 13 and 14: a one-chunk entry path's inputs through
    ``build_catalogue`` at ENTRY_CHUNKS chunks with read-ahead staging
    (``drive_entry``'s passes), held to the one-chunk run ``one``:
    the same catalogue (datasets, dtypes, shapes, attributes; exact sort,
    integers, SOAP/* and passthrough; floats within tolerance), device
    memory after each chunk at most the baseline plus the next prestaged
    store, a prestaged store equal to a serial one; with
    ``serial_pass``, one more pass without read-ahead."""
    inputs = one["inputs"]
    H = inputs["cat"].nr_halos
    run = drive_entry(tag, inputs, dev, timed, nr_chunks=ENTRY_CHUNKS, prefetch=True)
    out = run["out"]
    diffs = catalogue_differences(one["out"].catalogue, out.catalogue)
    if diffs:
        raise AssertionError(f"{tag}: catalogue differs from the one-chunk run: {diffs[:10]}")
    if not np.array_equal(one["out"].order, out.order):
        raise AssertionError(f"{tag}: sort order differs from the one-chunk run")
    for baseline, records in run["passes"]:
        for i, rec in enumerate(records):
            nxt = records[i + 1].store_bytes if i + 1 < len(records) else 0
            after = rec.memory_after[str(dev)]
            if after > baseline + nxt:
                raise AssertionError(
                    f"{tag}: chunk {rec.chunk_nr} left {after - baseline} bytes "
                    f"allocated, the next prestaged store is {nxt}")
    records = run["passes"][-1][1]
    n_one = sum(len(p) for p, _ in inputs["host"].values())
    n_staged = sum(r.particles for r in records)
    med = {k: [float(np.median([getattr(recs[i], k) for _, recs in run["passes"]]))
               for i in range(len(records))]
           for k in ("read_seconds", "wait_seconds", "engine_seconds")}
    hidden = 1.0 - sum(med["wait_seconds"][1:]) / max(sum(med["read_seconds"][1:]), 1e-9)
    say(tag, f"{len(records)} chunks of {[r.halos for r in records]} halos; particles staged "
        f"{n_staged} over all chunks against {n_one} for one chunk ({n_staged / n_one:.3f}x; "
        f"{[r.particles for r in records]}); median seconds per chunk: read and stage in the "
        f"reader thread {[round(x, 4) for x in med['read_seconds']]}, main thread waiting "
        f"in take() {[round(x, 4) for x in med['wait_seconds']]}, engine "
        f"{[round(x, 4) for x in med['engine_seconds']]}; share of read-and-stage hidden "
        f"behind compute (chunks 1 on) {hidden:.4f}; stores "
        f"{[round(r.store_bytes / 2**30, 3) for r in records]} GiB; memory_allocated after "
        f"each chunk's merge {[round(r.memory_after[str(dev)] / 2**30, 3) for r in records]} GiB "
        f"(baseline {run['passes'][-1][0] / 2**30:.3f}); peak {run['peak']:.2f} GiB "
        f"against the one-chunk run's {one['peak']:.2f}; halos/s median "
        f"{np.median(run['rates']):.2f} against {np.median(one['rates']):.2f}")
    say(tag, f"catalogue == the one-chunk run's ({len(out.catalogue.datasets)} datasets: "
        f"names, dtypes, shapes, attributes; exact sort, integers, SOAP/* and passthrough; "
        f"floats within tolerance); memory after each chunk within the baseline plus the "
        f"next prestaged store")
    check_prestage(tag, inputs, dev)
    if serial_pass:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ser = run_entry(inputs, dev, nr_chunks=ENTRY_CHUNKS, prefetch=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        say(tag, f"one pass without read-ahead: {H / dt:.2f} halos/s; per chunk read and "
            f"stage {[round(r.read_seconds, 4) for r in ser.chunks]}, engine "
            f"{[round(r.engine_seconds, 4) for r in ser.chunks]} s")
    return run


def phase_timings_chunked(dev):
    """Phase 13t: phase 5's 64-halo mock through ``build_catalogue`` at
    TIMING_CHUNKS chunks with per-halo and per-property timings, on the
    GPU against the CPU: the same catalogue (timings by name, dtype,
    shape and attributes), equal n_loop, process_time > 0 for every
    processed halo, every ``_time`` dataset >= 0 with a positive sum and
    equal across the keys of one spec."""
    uni = build_mock_universe(**ENGINE_MOCK)
    kw = dict(nr_chunks=TIMING_CHUNKS, record_halo_timings=True, record_property_timings=True)
    t0 = time.perf_counter()
    ref = run_entry(entry_inputs(uni, True), "cpu", **kw)
    t1 = time.perf_counter()
    rg.launches = il.launches = 0
    got = run_entry(entry_inputs(uni, True), dev, **kw)
    n1, n2 = rg.launches, il.launches
    t2 = time.perf_counter()
    diffs = catalogue_differences(ref.catalogue, got.catalogue)
    if diffs:
        raise AssertionError(f"timings: GPU catalogue differs from CPU: {diffs[:10]}")
    d = got.catalogue.datasets
    if not np.array_equal(d["InputHalos/n_loop"].data, ref.catalogue.datasets[
            "InputHalos/n_loop"].data):
        raise AssertionError("timings: n_loop differs between GPU and CPU")
    done = d["InputHalos/n_process"].data == 1
    if not done.all() or not (d["InputHalos/process_time"].data[done] > 0).all():
        raise AssertionError("timings: a processed halo has no process_time")
    by_group = {}
    for path, ds in d.items():
        if path.endswith("_time") and path != "InputHalos/process_time":
            by_group.setdefault(path.rsplit("/", 1)[0], []).append(ds.data)
    for group, arrays in by_group.items():
        if (arrays[0] < 0).any() or arrays[0].sum() <= 0 or any(
                not np.array_equal(a, arrays[0]) for a in arrays[1:]):
            raise AssertionError(f"timings: {group}'s _time datasets negative, zero or unequal")
    if n1 == 0 or n2 == 0:
        raise AssertionError(f"timings: GPU run bypassed a kernel: K1 {n1}, K2 {n2}")
    say("timings", f"{got.catalogue.n_halos} halos over {len(got.chunks)} chunks with halo "
        f"and property timings: GPU == CPU ({len(d)} datasets, timings by name only); "
        f"n_loop equal (max {int(d['InputHalos/n_loop'].data.max())}); process_time > 0 for "
        f"all; {len(by_group)} groups' _time datasets >= 0, positive sums, equal within "
        f"each spec; launches K1 {n1}, K2 {n2}; CPU run {t1 - t0:.1f} s, GPU {t2 - t1:.1f} s")
    return dict(launches={"range_gather": n1, "inertia_loop": n2}, catalogue=got.catalogue)


def neutrino_oracle(nu, boxsize, a, centres, r_phys):
    """(raw mass, weighted mass, count) per halo of the neutrinos within
    the physical radius ``r_phys`` of each comoving centre, in float64."""
    pos = np.asarray(nu["Coordinates"], np.float64)
    m = np.asarray(nu["Masses"], np.float64)
    mw = m * np.asarray(nu["Weights"], np.float64)
    out = []
    for c, r in zip(centres, r_phys):
        d = pos - c
        d -= boxsize * np.round(d / boxsize)
        inside = np.sqrt((d * d).sum(1)) * a <= r
        out.append((m[inside].sum(), mw[inside].sum(), int(inside.sum())))
    return np.array(out)


def phase_entry_neutrinos(dev, uni):
    """Phase 15: the hydro path's universe with NU_RATIO neutrinos per dark
    matter particle through the entry with FLAMINGO's list and context:
    a warm, NU_TIMED_PASSES timed and a checked pass; K1 launched for
    PartType6; the neutrino keys of the 16 most massive centrals against
    a float64 oracle at utils/parity.py's tolerances."""
    t0 = time.perf_counter()
    uni = add_neutrinos(uni, NU_RATIO, NU_SEED)
    nu = uni.extra_ptypes["PartType6"]
    inputs = entry_inputs(uni, False, "FLAMINGO")
    say("flamingo-nu-entry", f"{len(nu['Weights'])} neutrinos beside {len(uni.pos)} dark "
        f"matter particles ({len(nu['Weights']) / len(uni.pos):.4f}); "
        f"{float(np.mean(nu['Weights'] < 0)):.3f} of weights negative; inputs built in "
        f"{time.perf_counter() - t0:.1f} s")
    run = drive_entry("flamingo-nu-entry", inputs, dev, NU_TIMED_PASSES)
    k1_by = dict(sorted(run["out"].stats.k1_launches_by_ptype.items()))
    if k1_by.get("PartType6", 0) == 0:
        raise AssertionError(f"flamingo-nu-entry: K1 did not launch for PartType6: {k1_by}")
    say("flamingo-nu-entry", check_neutrino_keys(run["out"], uni)
        + f"; K1 launches by type {k1_by}")
    return run


def check_neutrino_keys(out, uni):
    """The neutrino keys of an entry run's 16 most massive centrals
    (SO/200_crit) against the float64 oracle; returns a line to print."""
    nu = uni.extra_ptypes["PartType6"]
    so = out.results["SO/200_crit"]
    central = np.flatnonzero(out.halos.is_central & (so["r"] > 0))
    top = central[np.argsort(-so["Mtot"][central], kind="stable")[:16]]
    want = neutrino_oracle(nu, uni.boxsize, uni.a, out.halos.cofp[top], so["r"][top])
    checks = {}
    for j, key in enumerate(("Mnu", "MnuNS", "Nnu")):
        got = np.asarray(so[key][top])
        if key == "Nnu":
            ok = np.array_equal(got.astype(np.int64), want[:, j].astype(np.int64))
        else:
            ok = key_close(want[:, j], got, key)
        checks[key] = float(f"{scaled_error(want[:, j], got):.3e}")
        if not ok:
            raise AssertionError(f"flamingo-nu-entry SO/200_crit/{key} differs from the "
                                 f"float64 oracle: {got.tolist()} against {want[:, j].tolist()}")
    return (f"16 most massive centrals: RawNeutrinoMass, NoiseSuppressedNeutrinoMass and "
            f"NumberOfNeutrinoParticles (SO/200_crit) equal the float64 oracle (scaled "
            f"errors {checks}); neutrinos inside {want[:, 2].astype(int).tolist()}; weighted "
            f"over raw {[round(float(x), 4) for x in want[:, 1] / np.maximum(want[:, 0], 1e-30)]}")


def phase_membership(uni):
    """Phase 16: ``compute_membership`` on the main universe's IDs in its
    snapshot order (``chunks.mock_fields``'s) against its bound lists:
    GroupNr_bound equal to mock_fields', Rank_bound to each particle's
    place in its bound list, on the card's host (numpy only).  Returns
    the snapshot IDs, their labels and the bound lists (phase 20)."""
    order = chunks._snapshot_order(np.asarray(uni.pos), uni.boxsize)
    snap_ids = np.asarray(uni.ids)[order]
    meta = mock_metadata(uni)
    specs = [s for s in build_specs(None, True, meta.virBN98) if s.kind == "bound"]
    host = mock_fields(uni, specs, meta, ["PartType1"])
    want_grnr = host["PartType1"][1]["GroupNr_bound"]
    lengths = np.array([len(ids) for ids in uni.bound_ids])
    ids_bound = np.concatenate(uni.bound_ids)
    grnr_bound = np.repeat(np.arange(uni.n_halos, dtype=np.int64), lengths)
    rank_bound = (np.arange(len(ids_bound)) - np.repeat(np.cumsum(lengths) - lengths,
                                                        lengths)).astype(np.int32)
    id_rank = np.full(int(snap_ids.max()) + 1, -1, np.int32)
    id_rank[ids_bound.astype(np.int64)] = rank_bound
    t0 = time.perf_counter()
    grnr, rank = compute_membership(snap_ids, ids_bound, grnr_bound, rank_bound)
    dt = time.perf_counter() - t0
    if not np.array_equal(grnr, want_grnr):
        raise AssertionError("membership: GroupNr_bound differs from the mock's labels")
    if not np.array_equal(rank, id_rank[snap_ids.astype(np.int64)]):
        raise AssertionError("membership: Rank_bound differs from the bound lists' order")
    say("membership", f"{len(snap_ids)} snapshot IDs against {len(ids_bound)} bound IDs of "
        f"{uni.n_halos} halos in {dt:.3f} s on the host ({len(snap_ids) / dt:.0f} IDs/s): "
        f"GroupNr_bound and Rank_bound equal the mock's labels ({int((grnr >= 0).sum())} "
        f"bound); h5py loaded: {'h5py' in sys.modules}")
    labels = dict(snap_ids=snap_ids, grnr=grnr, rank=rank, ids_bound=ids_bound,
                  grnr_bound=grnr_bound, rank_bound=rank_bound)
    # the same bound lists as a VR catalogue holds them: four files, each
    # with offsets local to its own bound IDs, and no rank
    files = []
    for rows in np.array_split(np.arange(uni.n_halos), 4):
        counts = lengths[rows]
        files.append((np.cumsum(counts) - counts,
                      np.concatenate([uni.bound_ids[i] for i in rows])))
    n_vr, ids_vr, grnr_vr = vr_groupnr(files)
    t0 = time.perf_counter()
    grnr, rank = compute_membership(snap_ids, ids_vr, grnr_vr)
    dt = time.perf_counter() - t0
    bound = grnr >= 0
    if n_vr != uni.n_halos or not np.array_equal(grnr, want_grnr):
        raise AssertionError("membership: the VR bound lists' GroupNr_bound differs")
    if not ((rank[bound] == 0).all() and (rank[~bound] == -1).all()):
        raise AssertionError("membership: the VR bound lists' Rank_bound is not 0 where bound")
    say("membership", f"the same bound lists as a VR catalogue over {len(files)} files: "
        f"{len(snap_ids)} IDs in {dt:.3f} s ({len(snap_ids) / dt:.0f} IDs/s); GroupNr_bound "
        f"equal to the mock's labels; Rank_bound 0 for all {int(bound.sum())} bound particles "
        f"(VR gives no rank)")
    return labels

#: phase 17's finders' names in the kernels line
FINDER_KEYS = {"VR": "vr", "Gadget4": "gadget4", "SubfindEagle": "subfind_eagle",
               "Rockstar": "rockstar", "RockstarBinary": "rockstar_binary"}
#: phase 17's finders: the four others, Rockstar both as an ASCII list
#: and as binary chunks (read by the Rockstar reader)
FINDERS = ("VR", "Gadget4", "SubfindEagle", "Rockstar", "RockstarBinary")
FINDER_TIMED_PASSES = 1  # phase 17's, to fit the run's time limit
#: the finders' passthrough groups in the catalogue
FINDER_GROUPS = {"VR": {"VR"}, "SubfindEagle": {"SubFind"}}
#: the catalogue's groups of computed properties
PROPERTY_GROUPS = ("BoundSubhalo", "SO", "ExclusiveSphere", "InclusiveSphere",
                   "ProjectedAperture")
#: phase 17c's finders and chunk counts
FINDERS_CHUNKED = ("VR", "Rockstar")
FINDER_CHUNKS = (1, 3)


def _halo_format(finder):
    return "Rockstar" if finder.startswith("Rockstar") else finder


def _bit_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_finders(dev, one):
    """Phase 17: phase 11's universe through the entry under each other
    finder (the same halos, centrality and bound counts in the same
    order, so its GroupNr_bound indexes them), each held to phase 11's
    catalogue group by group."""
    inputs = one["inputs"]
    meta, hbt = inputs["meta"], inputs["cat"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for finder in FINDERS:
            tag = f"{finder}-entry"
            t0 = time.perf_counter()
            cat = finder_catalogue(finder, hbt, meta.h, meta.a, tmp)
            t_read = time.perf_counter() - t0
            if not (np.array_equal(cat.is_central, hbt.is_central)
                    and np.array_equal(cat.nr_bound_part, hbt.nr_bound_part)):
                raise AssertionError(f"{tag}: centrality or bound counts differ from HBTplus's")
            centre_err = float(np.abs(cat.cofp - hbt.cofp).max())
            moved = int((cat.cofp != hbt.cofp).any(1).sum())
            run = drive_entry(tag, dict(inputs, cat=cat), dev, FINDER_TIMED_PASSES,
                              halo_format=_halo_format(finder))
            ref, what = one["out"], "phase 11's catalogue"
            if not np.allclose(cat.cofp, hbt.cofp, rtol=1e-14, atol=0.0):
                # the binary chunks' float32 centres: the HBTplus catalogue
                # at those centres and search radii, one pass
                ref = run_entry(dict(inputs, cat=dataclasses.replace(
                    hbt, cofp=cat.cofp, search_radius=cat.search_radius)), dev)
                what = "an HBTplus run at the same float32 centres"
            out = run["out"]
            got, want = out.catalogue, ref.catalogue
            diffs = catalogue_differences(want, got, groups=PROPERTY_GROUPS)
            if diffs:
                raise AssertionError(f"{tag}: property groups differ from {what}: {diffs[:10]}")
            if not np.array_equal(out.order, ref.order):
                raise AssertionError(f"{tag}: sort order differs from {what}")
            tops = {name: {p.split("/")[0] for p in c.datasets} for name, c in
                    (("got", got), ("want", want))}
            if (tops["got"] - tops["want"] != FINDER_GROUPS.get(finder, set())
                    or tops["want"] - tops["got"] != {"HBTplus", "SOAP"}):
                raise AssertionError(f"{tag}: groups {sorted(tops['got'])}, "
                                     f"against {sorted(tops['want'])}")
            for path, ds in want.datasets.items():
                if path.startswith("InputHalos/") and not (
                        _bit_equal(ds.data, got.datasets[path].data) or (
                        path == "InputHalos/HaloCentre"
                        and np.allclose(got.datasets[path].data, ds.data, rtol=1e-14, atol=0))):
                    raise AssertionError(f"{tag}: {path} differs from {what}")
            paths = [p for p in want.datasets if p.split("/")[0] in PROPERTY_GROUPS]
            n_bit = sum(_bit_equal(want.datasets[p].data, got.datasets[p].data) for p in paths)
            say(tag, f"catalogue built in {t_read:.3f} s; {moved} of {hbt.nr_halos} centres "
                f"moved, at most {centre_err:.3e} Mpc from phase 11's; {len(paths)} property "
                f"datasets within utils/parity.py's tolerances of {what}, {n_bit} of them "
                f"bit-equal; sort order, centrality, "
                f"bound counts and InputHalos the same; passthrough groups "
                f"{sorted(tops['got'] - tops['want'])}, no SOAP/* or HBTplus/*")
            runs[finder] = run
    return runs


def phase_finders_chunked(dev):
    """Phase 17c: VR and Rockstar (ASCII) catalogues of phase 5's mock
    (with satellites) through build_catalogue at 1 and at 3 chunks, on the
    GPU against the CPU: the same catalogue (datasets, dtypes, shapes,
    attributes; exact sort, passthrough and integers; floats within
    tolerance)."""
    uni = build_mock_universe(**ENGINE_MOCK)
    inputs = entry_inputs(uni, True)
    meta, hbt = inputs["meta"], inputs["cat"]
    launches = {"range_gather": 0, "inertia_loop": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for finder in FINDERS_CHUNKED:
            cat = finder_catalogue(finder, hbt, meta.h, meta.a, tmp)
            for n in FINDER_CHUNKS:
                kw = dict(nr_chunks=n, halo_format=finder)
                t0 = time.perf_counter()
                ref = run_entry(dict(inputs, cat=cat), "cpu", **kw)
                t1 = time.perf_counter()
                rg.launches = il.launches = 0
                got = run_entry(dict(inputs, cat=cat), dev, **kw)
                n1, n2 = rg.launches, il.launches
                t2 = time.perf_counter()
                diffs = catalogue_differences(ref.catalogue, got.catalogue)
                if diffs:
                    raise AssertionError(f"finders-chunked {finder} at {n} chunks: GPU "
                                         f"catalogue differs from CPU: {diffs[:10]}")
                if not np.array_equal(ref.order, got.order):
                    raise AssertionError(f"finders-chunked {finder} at {n} chunks: sort orders "
                                         f"differ")
                if n1 == 0 or n2 == 0 or len(got.chunks) != n:
                    raise AssertionError(f"finders-chunked {finder} at {n} chunks: "
                                         f"{len(got.chunks)} chunks, K1 {n1}, K2 {n2}")
                launches["range_gather"] += n1
                launches["inertia_loop"] += n2
                say("finders-chunked", f"{finder} at {n} chunk(s): {cat.nr_halos} halos "
                    f"({int((~cat.is_central).sum())} satellites), "
                    f"{len(got.catalogue.datasets)} datasets: GPU == CPU (names, dtypes, "
                    f"shapes, attributes; exact sort, passthrough and integers; floats within "
                    f"tolerance); launches K1 {n1}, K2 {n2}; CPU {t1 - t0:.1f} s, GPU "
                    f"{t2 - t1:.1f} s")
    return dict(launches=launches)


XRAY_RTOL = 1e-12


def phase_xray(dev, uni):
    """Phase 18: the hydro universe's gas through the X-ray interpolation
    of a mock 5D table, every default band and observing type at once,
    on the GPU against the CPU (float64 both)."""
    gas = uni.extra_ptypes["PartType0"]
    units = snapshot_attrs(uni)["Units"]
    ul, um = units["Unit length in cgs (U_L)"], units["Unit mass in cgs (U_M)"]
    rho = np.asarray(gas["Densities"], np.float64) * um / ul**3 / uni.a**3
    T = np.asarray(gas["Temperatures"], np.float64)
    mf = np.asarray(gas["ElementMassFractions"], np.float64)
    m = np.asarray(gas["Masses"], np.float64) * um
    bins, tables = xc.mock_table_5d()
    bands = [b for _ in xc.DEFAULT_OBSERVING_TYPES for b in xc.DEFAULT_BANDS]
    otypes = [o for o in xc.DEFAULT_OBSERVING_TYPES for _ in xc.DEFAULT_BANDS]
    z = 1.0 / uni.a - 1.0
    t0 = time.perf_counter()
    ref = xc.XrayCalculator.from_arrays(z, bins, tables, bands, otypes, "cpu").interpolate_tensor(
        rho, T, mf, m, bands, otypes)
    t_cpu = time.perf_counter() - t0
    calc = xc.XrayCalculator.from_arrays(z, bins, tables, bands, otypes, dev)
    t0 = time.perf_counter()
    lum = calc.interpolate(rho, T, mf, m, bands, otypes)  # from and to the host
    t_host = time.perf_counter() - t0
    args = [torch.tensor(x, device=dev) for x in (rho, T, mf, m)]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = calc.interpolate_tensor(*args, bands, otypes)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = got.cpu()
    if not (torch.equal(got, torch.from_numpy(lum)) and torch.isfinite(got).all()):
        raise AssertionError("xray: GPU results differ between calls or are not finite")
    if not torch.equal(got == 0, ref == 0) or not torch.allclose(got, ref, rtol=XRAY_RTOL,
                                                                   atol=0.0):
        raise AssertionError("xray: GPU luminosities differ from the CPU's")
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-300)).max().item()
    inside = float((ref[:, 0] > 0).double().mean())
    dt = float(np.median(times))
    say("xray", f"{len(rho)} gas particles x {len(bands)} band and observing-type columns "
        f"(table {tables[bands[0]][otypes[0]].shape}): GPU == CPU within rtol {XRAY_RTOL} "
        f"(max rel err {rel:.3e}), {inside:.4f} of particles inside the table; GPU median "
        f"{dt * 1e3:.2f} ms of 3 ({len(rho) / dt:.4g} particles/s) on device-resident inputs, "
        f"{t_host:.3f} s from and to the host (first call); CPU {t_cpu:.2f} s")


def multi_devices():
    """Phase 19's device list: every local GPU when there are several,
    else two workers on card 0."""
    if torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cuda", 0)] * 2


def _cards(devices):
    return list({str(d): d for d in devices}.values())


def phase_multi_device(dev, one):
    """Phase 19: halo batches over ``multi_devices()`` (one worker per
    entry): (a) phase 5's mock through ``ShardedHaloEngine`` against
    ``HaloEngine`` on ``dev``, every key bit-equal; (b) two chunks with a
    satellite, each on its group, against each chunk on ``dev``, bit for
    bit; (c) phase 11's entry (``one``) over the list: a warm pass, a
    timed pass (launch counters set to 0 just before it and read just
    after) and a checked pass (every K1 and K2 call of every device
    against its plain version), the catalogue bit-equal to phase 11's;
    (d) ``graft_entry.dryrun_multichip`` on the list."""
    devices = multi_devices()
    names = [str(d) for d in devices]
    if len(_cards(devices)) > 1:
        say("multi-device", f"{len(devices)} cards: {names}")
    else:
        say("multi-device", f"only one card was seen: two workers on it, {names}")

    # (a) phase 5's mock: the split against one device, bit for bit
    t0 = time.perf_counter()
    uni, (ctx, chunk, args, specs) = engine_inputs(dev)
    single = HaloEngine(ctx, chunk, specs, dev)
    ref = single.process(**args)
    sharded = ShardedHaloEngine(ctx, [chunk], specs, [devices])
    got = sharded.process(**{k: [v] for k, v in args.items()})[0]
    torch.cuda.synchronize()
    bad = bit_differences(ref, got)
    st = sharded.stats
    if bad or _counters(st) != _counters(single.stats):
        raise AssertionError(f"multi-device (a): {len(bad)} keys not bit-equal {bad[:10]}, "
                             f"counters {_counters(st)} against {_counters(single.stats)}")
    say("multi-device", f"(a) phase 5's mock ({uni.n_halos} halos, "
        f"{sum(len(d) for d in got.values())} keys): ShardedHaloEngine over {names} "
        f"bit-equal to HaloEngine on {dev}; counters equal {_counters(st)}; shares by worker "
        f"{dict(sorted(st.shares_by_worker.items()))}, K1 {dict(st.k1_launches_by_ptype)}; "
        f"{time.perf_counter() - t0:.2f} s")

    # (b) two chunks, each on its group, halo 0 of the first a satellite
    t0 = time.perf_counter()
    uni = build_mock_universe(n_halos=10, n_field=6000, boxsize=40.0, seed=3,
                              mass_range=(3.2, 60.0))
    ctx, chunk, _, _ = _bench_inputs(uni, dev)
    specs2 = [s for s in build_specs(None, True, 100.0) if s.group in ("BoundSubhalo",
                                                                        "SO/200_crit")]
    parts = np.array_split(np.arange(uni.n_halos), 2)
    lists = dict(
        centres=[uni.halo_pos[p] for p in parts],
        search_radius_phys=[uni.halo_renclose[p] * uni.a * 1.01 for p in parts],
        index=[p.astype(np.int64) for p in parts],
        is_central=[np.arange(len(p)) != 0 if c == 0 else np.ones(len(p), bool)
                    for c, p in enumerate(parts)],
        fof_id=[p.astype(np.int64) + 1 for p in parts],
    )
    two = ShardedHaloEngine(ctx, [chunk, chunk], specs2, device_grid(devices, 2)).process(
        **lists)
    for c in range(2):
        want = HaloEngine(ctx, chunk, specs2, dev).process(**{k: v[c] for k, v in lists.items()})
        bad = bit_differences(want, two[c])
        if bad:
            raise AssertionError(f"multi-device (b): chunk {c} differs from {dev}: {bad[:10]}")
    if two[0]["SO/200_crit"]["Mtot"][0] != 0 or not two[0]["BoundSubhalo"]["Mtot"][0] > 0:
        raise AssertionError("multi-device (b): the satellite has an SO mass or no bound mass")
    say("multi-device", f"(b) two chunks of {[len(p) for p in parts]} halos on groups "
        f"{[[str(d) for d in g] for g in device_grid(devices, 2)]}: each bit-equal to its chunk "
        f"on {dev}; the satellite's SO/200_crit zero; {time.perf_counter() - t0:.2f} s")

    # (c) phase 11's entry over the list
    inputs, H = one["inputs"], one["inputs"]["cat"].nr_halos
    t0 = time.perf_counter()
    run_entry(inputs, devices)
    torch.cuda.synchronize()
    say("multi-device", f"(c) main entry over {names}: warm pass {time.perf_counter() - t0:.2f} s")
    for d in _cards(devices):
        torch.cuda.reset_peak_memory_stats(d)
    rg.launches = il.launches = red.launches = 0
    il.cluster_launches.clear()
    hs.k2_launches_by_config.clear()
    t0 = time.perf_counter()
    out = run_entry(inputs, devices)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"range_gather": rg.launches, "inertia_loop": il.launches}
    k3 = red.launches
    if launches["range_gather"] == 0 or launches["inertia_loop"] == 0 or k3 == 0:
        raise AssertionError(f"multi-device (c) path bypassed a kernel: {launches}, K3 {k3}")
    # per card, the most allocated in the timed pass, as the chunk loop read it
    peak = {str(d): round(max(r.peak_memory[str(d)] for r in out.chunks) / 2**30, 2)
            for d in _cards(devices)}
    want, cat = one["out"].catalogue, out.catalogue
    bad = [p for p, ds in want.datasets.items()
           if p not in cat.datasets or not _bit_equal(ds.data, cat.datasets[p].data)]
    diffs = catalogue_differences(want, cat)
    if bad or diffs or set(cat.datasets) != set(want.datasets):
        raise AssertionError(f"multi-device (c): catalogue differs from phase 11's: "
                             f"{bad[:10]} {diffs[:10]}")
    st = out.stats
    with PathCheck() as check:
        run_entry(inputs, devices)
        torch.cuda.synchronize()
    if (check.k1["calls"], check.k2["calls"], check.k3["calls"]) != (*launches.values(), k3):
        raise AssertionError(f"multi-device (c) checked pass made {check.k1['calls']} K1, "
                             f"{check.k2['calls']} K2 and {check.k3['calls']} K3 calls, the "
                             f"timed pass {launches}, K3 {k3}")
    on_devices = sorted(set(check.k1["devices"]) | set(check.k2["devices"])
                        | set(check.k3["devices"]))
    if len(_cards(devices)) > 1 and on_devices != sorted(str(d) for d in _cards(devices)):
        raise AssertionError(f"multi-device (c): kernels launched on {on_devices} only")
    say("multi-device", f"(c) main entry over {names}: {H} halos in one timed pass "
        f"{dt:.4f} s, {H / dt:.2f} halos/s against phase 11's median "
        f"{np.median(one['rates']):.2f} ({H / dt / np.median(one['rates']):.3f}x); engine "
        f"{out.engine_seconds:.4f} s (phase 11 {one['out'].engine_seconds:.4f}); shares by worker "
        f"{dict(sorted(st.shares_by_worker.items()))}, seconds by worker "
        f"{ {k: round(v, 4) for k, v in sorted(st.worker_seconds.items())} }; tiles "
        f"{st.n_bucket_calls}; peak device memory per card {peak} GiB (phase 11 "
        f"{one['peak']:.2f}); launches {launches}; catalogue bit-equal to phase 11's "
        f"({len(cat.datasets)} datasets)")
    say("multi-device", f"(c) checked pass, every call against its plain version: K1 "
        f"bit-equal, {check.k1['calls']} calls by device {check.k1['devices']}; K2 within "
        f"rtol {K2_RTOL}, {check.k2['calls']} calls by device {check.k2['devices']} (max abs "
        f"err {check.k2['max_abs_err']:.3e}); {k3_line(check.k3)} by device "
        f"{check.k3['devices']}"
        + ("" if len(_cards(devices)) > 1 else "; only one card was seen, so no launch on "
           "cuda:1 (the device guard is not exercised)"))

    # (d) the graft entry's dry run on the list
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(devices)
    say("multi-device", f"(d) dryrun_multichip on {names}: seconds "
        f"{ {k: round(v, 4) for k, v in dry['seconds'].items()} }; "
        f"{time.perf_counter() - t0:.2f} s")
    return dict(launches=launches, check={"range_gather": check.k1, "inertia_loop": check.k2},
                out=out)


#: phase 20: the command line's subcommands (the JAX CLI's) and the tool modules
SUBCOMMANDS = ("halo-properties", "membership", "compress", "extract-filters", "compare",
               "property-table", "virtual-snapshot", "empty-catalogue", "recalculate-xrays",
               "convert-eagle", "hydrogen-fractions", "check-membership", "birth-halo-index",
               "fof-radii", "timing-analysis", "match-halos")
TOOL_MODULES = ("compare", "compression", "convert_eagle", "docs", "fof_radii",
                "hydrogen_phases", "match_membership", "membership_checks", "reorder_fof",
                "timing_analysis", "track_evolution", "virtual_snapshot", "xray_calculator")
#: phase 20's seed for the relabelled copy of the main universe
RELABEL_SEED = 14


def _relabelled(labels, central, rng):
    """The bound particles of ``labels`` (phase 16's) as two simulations'
    ``match_sim`` inputs: the first as they are, catalogue index = row;
    the second with its rows permuted, new catalogue indices and the
    particles in reverse order.  Returns (d1, cat1, d2, cat2, perm): row
    r of the second catalogue is row perm[r] of the first."""
    bound = labels["grnr"] >= 0
    d1 = dict(particle_ids=labels["snap_ids"][bound],
              halo_ids=labels["grnr"][bound].astype(np.int64), rank_bound=labels["rank"][bound])
    H = len(central)
    host = np.full(H, -1, np.int64)  # satellites' host rows: none in the main universe
    cat1 = match_membership.MatchCatalogue(np.arange(H, dtype=np.int64), central, host)
    perm = rng.permutation(H)
    new_index = 7 * np.arange(H, dtype=np.int64) + 100_000  # by row of the first
    d2 = {k: v[::-1] for k, v in d1.items()}
    d2["halo_ids"] = new_index[d2["halo_ids"]]
    cat2 = match_membership.MatchCatalogue(new_index[perm], central[perm], host)
    return d1, cat1, d2, cat2, perm


def phase_host_tools(smi, labels, uni, hydro_uni, entry_catalogue, timings_catalogue):
    """Phase 20: the command line's file tools on the card's host, where
    there is no h5py and no jax: every tool module and the parser import,
    and the parser lists the sixteen subcommands; then the tools' array
    halves at the earlier phases' sizes, each timed: ``match_sim`` both
    ways between phase 6's universe (phase 16's labels) and a relabelled,
    reordered copy, recovering the relabelling exactly with every match
    consistent; the membership label check on phase 16's labels, which
    passes and raises after one corrupted label; the hydrogen fractions
    of phase 8's gas (each in [0, 1], HI + HII + 2 H2 = 1 to 1e-12);
    ``build_matrix`` on phase 11's inertia tensors (symmetric, and
    flattening back gives the input); the timing statistics and report of
    phase 13t's catalogue; both documentation generators, one row per
    property of the table.  Fails if h5py or jax was loaded."""
    t_start = time.perf_counter()
    lines = []

    def timed(name, rows, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        lines.append(f"{name} {rows} rows {dt:.4f} s ({rows / dt:.4g} rows/s)")
        return out

    modules = timed("import", len(TOOL_MODULES), lambda: [
        importlib.import_module(f"soap_tpu_torch.tools.{m}") for m in TOOL_MODULES])
    listed = tuple(cli.subcommands(cli.build_parser()))
    if listed != SUBCOMMANDS:
        raise AssertionError(f"host-tools: the parser lists {listed}")

    # match_sim both ways against a relabelled copy
    central = np.asarray(uni.halo_rank) == 0
    d1, cat1, d2, cat2, perm = _relabelled(labels, central, np.random.default_rng(RELABEL_SEED))
    n = len(d1["particle_ids"])
    m12, c12 = timed("match_sim 1->2", n, lambda: match_membership.match_sim(d1, d2, cat1, cat2))
    m21, c21 = timed("match_sim 2->1", n, lambda: match_membership.match_sim(d2, d1, cat2, cat1))
    inverse = np.argsort(perm)
    nbound = np.bincount(d1["halo_ids"], minlength=len(central))
    if not (np.array_equal(m12[central], inverse[central]) and (m12[~central] == -1).all()
            and np.array_equal(m21[central[perm]], perm[central[perm]])
            and np.array_equal(c12[central], np.minimum(50, nbound)[central])):
        raise AssertionError("host-tools: match_sim did not recover the relabelling")
    for a, b in ((m12, m21), (m21, m12)):
        if not match_membership.consistent_match(a, b)[a >= 0].all():
            raise AssertionError("host-tools: a match is not consistent")

    # the membership label check, and its rejection of a corrupted label
    args = (labels["snap_ids"], labels["grnr"], labels["rank"], len(central),
            labels["ids_bound"], labels["grnr_bound"], labels["rank_bound"])
    stats = timed("check_labels", len(labels["snap_ids"]),
                  lambda: membership_checks.check_labels(*args))
    if stats["n_labelled"] != len(labels["ids_bound"]):
        raise AssertionError(f"host-tools: check_labels counted {stats}")
    bad = labels["grnr"].copy()
    row = np.flatnonzero(bad == 1)[0]
    bad[row] = 2
    try:
        membership_checks.check_labels(args[0], bad, *args[2:])
    except RuntimeError as e:
        rejected = str(e)
    else:
        raise AssertionError("host-tools: check_labels passed a corrupted label")

    # the hydrogen fractions of the hydro universe's gas
    gas = hydro_uni.extra_ptypes["PartType0"]
    meta = mock_metadata(hydro_uni)
    hi, hii, h2 = timed("hydrogen_fractions", len(gas["Temperatures"]),
                        lambda: hydrogen_phases.hydrogen_fractions(
                            np.asarray(gas["Temperatures"], np.float64),
                            np.asarray(gas["Densities"], np.float64),
                            np.asarray(gas["ElementMassFractions"][:, 0], np.float64),
                            np.asarray(gas["Pressures"], np.float64), meta.snap_units_cgs,
                            meta.a, meta.z))
    total = np.abs(hi + hii + 2.0 * h2 - 1.0).max()
    if not all(((x >= 0) & (x <= 1)).all() for x in (hi, hii, h2)) or not total <= 1e-12:
        raise AssertionError(f"host-tools: hydrogen fractions outside [0, 1] or off by {total}")

    # build_matrix on the main entry's inertia tensors
    tensors = [ds.data for path, ds in entry_catalogue.datasets.items()
               if "InertiaTensor" in path and ds.data.ndim == 2 and ds.data.shape[1] == 6]
    flat = np.concatenate(tensors)
    mats = timed("build_matrix", len(flat), lambda: fof_radii.build_matrix(flat))
    row_i, col_i = np.tril_indices(3)
    off = row_i != col_i
    back = np.concatenate([np.diagonal(mats, axis1=1, axis2=2), mats[:, row_i[off], col_i[off]]],
                          axis=1)
    if not (np.array_equal(mats, mats.transpose(0, 2, 1)) and np.array_equal(back, flat)):
        raise AssertionError("host-tools: build_matrix is not symmetric or does not round-trip")

    # the timing statistics and report of phase 13t's catalogue
    d = timings_catalogue.datasets
    t_stats = timed("timing_stats", len(d["InputHalos/process_time"].data), lambda: (
        timing_analysis.timing_stats(d["InputHalos/process_time"].data,
                                     d["InputHalos/n_loop"].data,
                                     d["InputHalos/NumberOfBoundParticles"].data),
        timing_analysis.group_seconds((p, ds.data) for p, ds in d.items())))
    text = timing_analysis.format_report(*t_stats)
    if t_stats[0]["n_halos"] != timings_catalogue.n_halos or not t_stats[1]:
        raise AssertionError(f"host-tools: timing statistics {t_stats}")

    # both documentation generators
    n_props = len(full_property_table())
    rst, tex = timed("docs", 2 * n_props, lambda: (docs.generate_rst(), docs.generate_latex()))
    rows = (sum(line.startswith("   * - ``") for line in rst.splitlines()),
            sum(line.startswith("\\texttt{") for line in tex.splitlines()))
    if rows != (n_props, n_props):
        raise AssertionError(f"host-tools: documentation rows {rows}, the table {n_props}")

    loaded = [m for m in ("h5py", "jax", "yaml") if m in sys.modules]
    if loaded:
        raise AssertionError(f"host-tools: loaded {loaded}")
    say("host-tools", f"{len(modules)} tool modules and the parser's {len(listed)} subcommands "
        f"import without h5py, jax or yaml; match_sim both ways over {n} bound particles of "
        f"{len(central)} halos recovers the relabelling (counts min(50, Nbound)), every match "
        f"consistent; check_labels passes {stats} and rejects a corrupted label "
        f"({rejected!r}); hydrogen fractions of {len(hi)} gas particles in [0, 1], "
        f"|HI + HII + 2 H2 - 1| <= {total:.3e}; build_matrix on {len(tensors)} inertia tensor "
        f"datasets ({len(flat)} rows) symmetric and round-trips; timing report of "
        f"{t_stats[0]['n_halos']} halos, {len(t_stats[1])} groups ({len(text)} characters); "
        f"docs {rows[0]} rows each; on {smi}; {'; '.join(lines)}; phase "
        f"{time.perf_counter() - t_start:.2f} s")


def phase_profile(dev, tag, inputs):
    """torch.profiler over one pass of a path: device time summed over
    kernel events only (each kernel once), beside unprofiled passes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ctx, chunk, args, specs = inputs
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        HaloEngine(ctx, chunk, specs, dev).process(**args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        HaloEngine(ctx, chunk, specs, dev).process(**args)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            d = by_name.setdefault(e.name, [0.0, 0])
            d[0] += e.time_range.elapsed_us() / 1e3
            d[1] += 1
    total = sum(v[0] for v in by_name.values())
    calls = sum(v[1] for v in by_name.values())
    say("profile", f"{tag} path: {total:.2f} ms device time in {calls} kernels; "
        f"unprofiled passes {', '.join(f'{w:.4f}' for w in walls)} s; busy share "
        f"{total / 1e3 / float(np.median(walls)):.3f}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        say("profile", f"  {ms:9.3f} ms {100 * ms / total:5.1f}% {n:6d} calls  {name[:90]}")


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
    if "--kernels-only" in sys.argv[1:]:
        k1 = {cell[0]: phase_k1(dev, cell) for cell in K1_CELLS}
        k2 = phase_k2(dev)
        k3 = phase_k3(dev)
        print(json.dumps({"kernels": {"range_gather": k1, "inertia_loop": k2,
                                      "particle_sum": k3}}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--multi-device-only" in sys.argv[1:]:
        phase_multi_device(dev, phase_entry_main(dev, build_mock_universe(**BENCH)))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    k1 = {cell[0]: phase_k1(dev, cell) for cell in K1_CELLS}
    k2 = phase_k2(dev)
    k3 = phase_k3(dev)
    phase_engine(dev)
    phase_engine_hydro(dev)
    phase_capacity(dev)
    phase_neutrinos(dev)
    phase_engine_params(dev)
    phase_entry(dev)
    main_run, main_uni = phase_main(dev)
    giant_run = phase_giant(dev)
    hydro_run, hydro_uni = phase_hydro(dev)
    colibre_run = phase_colibre(dev, hydro_uni)
    every_key_run = phase_colibre_every_key(dev, hydro_uni)
    main_entry_run = phase_entry_main(dev, main_uni)
    flamingo_entry_run = phase_entry_flamingo(dev, hydro_uni)
    main_chunked_run = phase_entry_chunked("main-entry-chunked", dev, main_entry_run,
                                           CHUNKED_TIMED_PASSES)
    timings_run = phase_timings_chunked(dev)
    flamingo_chunked_run = phase_entry_chunked("flamingo-entry-chunked", dev,
                                               flamingo_entry_run, FLAMINGO_CHUNKED_PASSES,
                                               serial_pass=False)
    nu_entry_run = phase_entry_neutrinos(dev, hydro_uni)
    labels = phase_membership(main_uni)
    finder_runs = phase_finders(dev, main_entry_run)
    finders_chunked_run = phase_finders_chunked(dev)
    phase_xray(dev, hydro_uni)
    multi_run = phase_multi_device(dev, main_entry_run)
    phase_host_tools(smi, labels, main_uni, hydro_uni, main_entry_run["out"].catalogue,
                     timings_run["catalogue"])
    if "--profile" in sys.argv[1:]:
        phase_profile(dev, "main", main_run["inputs"])
        phase_profile(dev, "hydro", hydro_run["inputs"])
        phase_profile(dev, "colibre", colibre_run["inputs"])

    # launches: the main path's count; giant_path_launches,
    # hydro_path_launches, colibre_path_launches,
    # colibre_every_key_path_launches, main_entry_path_launches,
    # flamingo_entry_path_launches, main_entry_chunked_path_launches,
    # flamingo_entry_chunked_path_launches (one timed pass over all
    # chunks), timings_chunked_path_launches (phase 13t's GPU run) and
    # flamingo_nu_entry_path_launches (phase 15), vr_, gadget4_,
    # subfind_eagle_, rockstar_ and rockstar_binary_entry_path_launches
    # (phase 17) and finders_chunked_path_launches (phase 17c's GPU runs,
    # summed): those paths';
    # path_checks: each path's checked
    # pass (calls, max abs err against the plain version, the shapes it
    # gave the kernel in brief); cell, ms, plain_ms, bound_ms and
    # library_ms: the phase-3/4 cell's.  The giant K2 cell stands for the streaming TPU
    # kernel.
    runs = {"main": main_run, "giant": giant_run, "hydro": hydro_run,
            "colibre": colibre_run, "colibre-every-key": every_key_run,
            "main-entry": main_entry_run, "flamingo-entry": flamingo_entry_run,
            "main-entry-chunked": main_chunked_run,
            "flamingo-entry-chunked": flamingo_chunked_run,
            "flamingo-nu-entry": nu_entry_run,
            **{f"{f}-entry": r for f, r in finder_runs.items()},
            "multi-device-entry": multi_run}

    def summary(check):
        """A checked pass in brief: calls, max abs error, and the range of
        halos B and rows (capacity or K) over its distinct shapes (the
        shapes themselves are on the path's lines above)."""
        dims = [dict(kv.split("=") for kv in shape.split()) for shape in check["shapes"]]
        rows = [int(d.get("capacity", d.get("K", 0))) for d in dims]
        bs = [int(d["B"]) for d in dims]
        return dict(calls=check["calls"], max_abs_err=check["max_abs_err"],
                    distinct_shapes=len(dims), B=[min(bs, default=0), max(bs, default=0)],
                    rows=[min(rows, default=0), max(rows, default=0)],
                    devices=check["devices"])

    def path(name):
        return dict(launches=main_run["launches"][name],
                    giant_path_launches=giant_run["launches"][name],
                    hydro_path_launches=hydro_run["launches"][name],
                    colibre_path_launches=colibre_run["launches"][name],
                    colibre_every_key_path_launches=every_key_run["launches"][name],
                    main_entry_path_launches=main_entry_run["launches"][name],
                    flamingo_entry_path_launches=flamingo_entry_run["launches"][name],
                    main_entry_chunked_path_launches=main_chunked_run["launches"][name],
                    flamingo_entry_chunked_path_launches=flamingo_chunked_run["launches"][name],
                    timings_chunked_path_launches=timings_run["launches"][name],
                    flamingo_nu_entry_path_launches=nu_entry_run["launches"][name],
                    **{f"{FINDER_KEYS[f]}_entry_path_launches": r["launches"][name]
                       for f, r in finder_runs.items()},
                    finders_chunked_path_launches=finders_chunked_run["launches"][name],
                    multi_device_entry_path_launches=multi_run["launches"][name],
                    path_checks={t: summary(r["check"][name]) for t, r in runs.items()})

    kernels = [
        dict(name="range_gather", route="cuda",
             source="soap_tpu_torch/csrc/range_gather.cu",
             replaces="soap_tpu/ops/dma_gather.py:247", cell_name=cell,
             **path("range_gather"), **k1[cell])
        for cell in k1
    ] + [
        dict(name="inertia_loop", route="cuda",
             source="soap_tpu_torch/csrc/inertia_loop.cu",
             replaces="soap_tpu/ops/pallas_inertia.py:"
                      + ("480" if cell == "giant" else "461"), cell_name=cell,
             **path("inertia_loop"), **k2[cell])
        for cell in k2
    ] + [
        # K3 replaces no TPU kernel; its launches: the particle sums of
        # one timed pass of each engine path
        dict(name="particle_sum", route="cuda",
             source="soap_tpu_torch/csrc/particle_sum.cu", replaces=None, cell_name=cell,
             launches=main_run["k3"]["particle_sum"],
             giant_path_launches=giant_run["k3"]["particle_sum"],
             hydro_path_launches=hydro_run["k3"]["particle_sum"],
             colibre_path_launches=colibre_run["k3"]["particle_sum"],
             colibre_every_key_path_launches=every_key_run["k3"]["particle_sum"],
             **k3[cell])
        for cell in k3
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
