"""The port's command line, ``python -m soap_tpu_torch``, on the CPU.

``halo-properties`` in direct-path mode and in parameter-file mode (a
copy of MINIMAL_FLAMINGO's file with the mock's paths, templated with
``{sim_dir}``, ``{sim_name}`` and ``{snap_nr:04d}``), ``membership
--halo-format VR`` and ``recalculate-xrays``, each run as its own
process with ``--device cpu`` where it takes one, write what the
function they call writes when called directly; every flag maps onto its
keyword (with ``cuda`` the default device); ``--profile`` writes a
torch.profiler trace.  Each of the thirteen file subcommands, called in
this process, prints what the JAX CLI prints for the same arguments,
returns its exit code, and writes what its tool writes when called
directly; ``--help`` lists all sixteen subcommands.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

from soap_tpu import cli as jax_cli
from soap_tpu.pipeline.membership import run_group_membership as jax_membership
from soap_tpu.utils.mock_data import build_mock_universe, make_mock_simulation
from soap_tpu_torch import cli
from soap_tpu_torch.core.params import ParameterFile, substitute_parameters
from soap_tpu_torch.io.catalogue_writer import read_catalogue
from soap_tpu_torch.io.halo_catalogue import read_hbtplus_catalogue, read_hbtplus_groupnr
from soap_tpu_torch.pipeline.membership import run_group_membership
from soap_tpu_torch.pipeline.run import compute_halo_properties
from soap_tpu_torch.tools import (
    compare, compression, convert_eagle, docs, fof_radii, hydrogen_phases, match_membership,
    membership_checks, timing_analysis, virtual_snapshot,
)
from soap_tpu_torch.tools import xray_calculator as xc
from soap_tpu_torch.utils import mock_finders
from soap_tpu_torch.utils.parity import catalogue_differences
from test_convert_eagle import BOX_HFREE, _write_eagle_mock
from test_match_membership import _write_sim
from test_membership_checks import _mini_snap
from test_torch_tools import _lossy_catalogue, assert_same_h5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv):
    """``python -m soap_tpu_torch`` in its own process, on one OpenMP
    thread (the test runs beside other test processes)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "soap_tpu_torch", *argv], cwd=REPO,
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def _same_h5(got, want, skip=()):
    items = {}
    for name, path in (("got", got), ("want", want)):
        with h5py.File(path, "r") as f:
            out = {}
            f.visititems(lambda n, o, acc=out: acc.__setitem__(n, (o[()], dict(o.attrs)))
                         if isinstance(o, h5py.Dataset) else None)
            items[name] = out
    assert sorted(items["got"]) == sorted(items["want"])
    for n, (data, attrs) in items["want"].items():
        if n in skip:
            continue
        g, ga = items["got"][n]
        assert g.dtype == data.dtype and np.array_equal(g, data), n
        assert sorted(ga) == sorted(attrs), n


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    sim = make_mock_simulation(tmp, n_halos=6, n_field=3000, boxsize=16.0, seed=11)
    mem = os.path.join(tmp, "membership_0077.hdf5")
    jax_membership(sim["snapshot"], sim["hbt_basename"], mem)
    return dict(sim, tmp=tmp, membership=mem)


def test_halo_properties_direct_paths(sim, tmp_path):
    """Direct-path mode writes what ``compute_halo_properties`` writes."""
    out = str(tmp_path / "cli.hdf5")
    _cli("halo-properties", "--snapshot", sim["snapshot"], "--membership", sim["membership"],
         "--halo-basename", sim["hbt_basename"], "--output", out, "--dmo", "--device", "cpu")
    direct = str(tmp_path / "direct.hdf5")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        compute_halo_properties(sim["snapshot"], sim["membership"], sim["hbt_basename"], direct,
                                dmo=True, device="cpu", verbose=False)
    finally:
        torch.set_num_threads(threads)
    assert catalogue_differences(read_catalogue(direct), read_catalogue(out)) == []


def _parameter_file(sim, tmp_path):
    """MINIMAL_FLAMINGO's file with the mock's paths as SOAP templates."""
    with open(os.path.join(REPO, "parameter_files", "MINIMAL_FLAMINGO.yml")) as f:
        raw = yaml.safe_load(f)
    raw["Parameters"] = {"sim_dir": sim["tmp"], "output_dir": str(tmp_path)}
    raw["Snapshots"] = {"filename": "{sim_dir}/snap_{snap_nr:04d}.hdf5"}
    raw["GroupMembership"] = {"filename": "{sim_dir}/membership_{snap_nr:04d}.hdf5"}
    raw["HaloFinder"] = {"filename": "{sim_dir}/SubSnap_{snap_nr:03d}", "type": "HBTplus"}
    raw["HaloProperties"] = {"filename": "{output_dir}/{sim_name}_{snap_nr:04d}.hdf5"}
    path = str(tmp_path / "params.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path, raw


def test_halo_properties_parameter_file(sim, tmp_path):
    """Parameter-file mode: the templated paths, the file's list and
    filters; the file equals a direct call with the same parameters, and
    the used-parameters mirror is written beside it."""
    path, raw = _parameter_file(sim, tmp_path)
    _cli("halo-properties", path, "--sim-name", "L0016N0064", "--snap-nr", "77", "--dmo",
         "--device", "cpu")
    out = str(tmp_path / "L0016N0064_0077.hdf5")
    assert os.path.exists(tmp_path / "SOAP.used_parameters.yml")
    params = ParameterFile(parameter_dictionary=substitute_parameters(
        raw, {"sim_name": "L0016N0064"}))
    direct_dir = tmp_path / "direct"
    direct_dir.mkdir()
    direct = str(direct_dir / "direct.hdf5")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        compute_halo_properties(sim["snapshot"], sim["membership"], sim["hbt_basename"], direct,
                                parameter_file=params, dmo=True, device="cpu", verbose=False)
    finally:
        torch.set_num_threads(threads)
    ours, theirs = read_catalogue(out), read_catalogue(direct)
    assert catalogue_differences(theirs, ours) == []
    assert ours.groups["Parameters"]["swift_filename"] == sim["snapshot"]
    assert sum(p.startswith("SO/200_mean/") for p in ours.datasets) > 5


def test_membership_vr(sim, tmp_path):
    """``membership --halo-format VR`` writes ``run_group_membership``'s
    file for the same VR catalogue (Rank_bound 0 for bound particles)."""
    uni = sim["universe"]
    cat = read_hbtplus_catalogue(sim["hbt_basename"], h=uni.h)
    vr = mock_finders.write_finder_files(str(tmp_path), cat, uni.h, uni.a,
                                         read_hbtplus_groupnr(sim["hbt_basename"])[1])["VR"]
    out, direct = str(tmp_path / "cli_membership.hdf5"), str(tmp_path / "direct.hdf5")
    _cli("membership", "--snapshot", sim["snapshot"], "--halo-basename", vr, "--halo-format",
         "VR", "--output", out, "--batch-rows", "1000")
    run_group_membership(sim["snapshot"], vr, direct, halo_format="VR")
    _same_h5(out, direct)
    with h5py.File(out, "r") as f:
        rank = f["PartType1/Rank_bound"][...]
        grnr = f["PartType1/GroupNr_bound"][...]
    assert (grnr >= 0).any() and (rank[grnr >= 0] == 0).all()


def test_recalculate_xrays(sim, tmp_path):
    """``recalculate-xrays`` writes ``compute_xray_luminosities``' file."""
    snap = make_mock_simulation(str(tmp_path), n_halos=3, n_field=1200, boxsize=12.0, seed=4,
                                hydro=True)["snapshot"]
    table = str(tmp_path / "xray_table_5d.hdf5")
    xc.write_mock_table_5d(table)
    out, direct = str(tmp_path / "cli_xray.hdf5"), str(tmp_path / "direct_xray.hdf5")
    r = _cli("recalculate-xrays", snap, table, out, "--bands", "ROSAT,erosita-low",
             "--device", "cpu")
    assert "XrayLuminosities" in r.stdout
    xc.compute_xray_luminosities(snap, table, direct, bands=["ROSAT", "erosita-low"],
                                 device="cpu")
    _same_h5(out, direct)


#: (arguments after the subcommand, keyword, value) for each flag
HALO_FLAGS = [
    ((), "device", "cuda"),
    (("--device", "cpu"), "device", "cpu"),
    ((), "prefetch", True),
    (("--no-prefetch",), "prefetch", False),
    (("--io-processes", "3"), "io_processes", 3),
    (("--chunks", "4"), "nr_chunks", 4),
    (("--scratch-dir", "scr"), "scratch_dir", "scr"),
    (("--host-index", "1"), "host_index", 1),
    (("--host-count", "2"), "host_count", 2),
    (("--dmo",), "dmo", True),
    (("--centrals-only",), "centrals_only", True),
    (("--max-halos", "5"), "max_halos", 5),
    (("--halo-indices", "3,1"), "halo_indices", [3, 1]),
    (("--halo-format", "Rockstar"), "halo_format", "Rockstar"),
    (("--reference-snapshot", "ref.hdf5"), "reference_snapshot", "ref.hdf5"),
    (("--fof-group-filename", "fof.hdf5"), "fof_filename", "fof.hdf5"),
    (("--record-halo-timings",), "record_halo_timings", True),
    (("--record-property-timings",), "record_property_timings", True),
    (("--output", "o.hdf5"), "output_file", "o.hdf5"),
    (("--membership", "m.hdf5"), "membership_file", "m.hdf5"),
    (("--halo-basename", "hb"), "halo_basename", "hb"),
]
MEMBERSHIP_FLAGS = [
    (("--batch-rows", "64"), "batch_rows", 64),
    ((), "batch_rows", None),
    (("--fof-filename", "fof.hdf5"), "fof_filename", "fof.hdf5"),
    (("--halo-format", "VR"), "halo_format", "VR"),
    (("--output", "m.hdf5"), "output_filename", "m.hdf5"),
    (("--halo-basename", "hb"), "halo_basename", "hb"),
    ((), "return_labels", False),
]
XRAY_FLAGS = [
    ((), "device", "cuda"),
    (("--device", "cpu"), "device", "cpu"),
    (("--bands", "ROSAT,erosita-high"), "bands", ["ROSAT", "erosita-high"]),
    ((), "bands", None),
]
CASES = ([("halo-properties",) + c for c in HALO_FLAGS]
         + [("membership",) + c for c in MEMBERSHIP_FLAGS]
         + [("recalculate-xrays",) + c for c in XRAY_FLAGS])


@pytest.mark.parametrize("command,flags,keyword,value", CASES,
                         ids=[f"{c[0]}:{' '.join(c[1]) or 'default'}:{c[2]}" for c in CASES])
def test_flag_maps_onto_keyword(command, flags, keyword, value):
    if command == "recalculate-xrays":
        args = cli.build_parser().parse_args([command, "s.hdf5", "t.hdf5", "o.hdf5", *flags])
        kwargs = cli.xray_kwargs(args)
    else:
        args = cli.build_parser().parse_args([command, "--snapshot", "s.hdf5", *flags])
        kwargs = (cli.halo_properties_kwargs(args) if command == "halo-properties"
                  else cli.membership_kwargs(args))
    got = kwargs[keyword]
    if isinstance(value, list) and isinstance(got, np.ndarray):
        got = got.tolist()
    assert got == value and type(got) is type(value)


def test_profile_writes_trace(sim, tmp_path, monkeypatch):
    """``--profile`` traces the run with torch.profiler into
    ``soap_tpu_torch_profile/`` under the working directory, with the
    program's spans among its ranges, and still writes the catalogue."""
    out = str(tmp_path / "profiled.hdf5")
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(["halo-properties", "--snapshot", sim["snapshot"], "--membership",
                         sim["membership"], "--halo-basename", sim["hbt_basename"], "--output",
                         out, "--dmo", "--device", "cpu", "--max-halos", "2", "--profile"]) == 0
    finally:
        torch.set_num_threads(threads)
    with open(tmp_path / cli.PROFILE_DIR / "trace.json") as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 100
    assert {"engine.bucket", "entry.post"} <= {e.get("name") for e in trace["traceEvents"]}
    assert read_catalogue(out).n_halos == 2


SUBCOMMANDS = ["halo-properties", "membership", "compress", "extract-filters", "compare",
               "property-table", "virtual-snapshot", "empty-catalogue", "recalculate-xrays",
               "convert-eagle", "hydrogen-fractions", "check-membership", "birth-halo-index",
               "fof-radii", "timing-analysis", "match-halos"]


def test_help_lists_every_subcommand():
    """``python -m soap_tpu_torch --help`` in its own process lists the
    sixteen subcommands, the JAX CLI's, and loads no jax, soap_tpu, h5py
    or yaml on the way."""
    assert cli.subcommands(cli.build_parser()) == SUBCOMMANDS
    r = _cli("--help")
    listed = r.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert listed == SUBCOMMANDS
    code = ("import sys, runpy\n"
            "sys.argv = ['soap_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('soap_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'soap_tpu', 'h5py', 'yaml')]\n"
            "print('loaded', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("loaded []")


@pytest.fixture(scope="module")
def tool_inputs(sim, tmp_path_factory):
    """Inputs of the file subcommands: ``sim``'s snapshot, membership and
    HBTplus catalogue, a hydro mock, a FOF catalogue of ``sim``'s groups,
    a catalogue under every lossy filter and its compressed copy, a
    snapshot with real lossy pipelines and its filters file, a catalogue
    with timing datasets, the birth-halo test's snapshots, the match
    test's two simulations and the EAGLE conversion test's files."""
    tmp = tmp_path_factory.mktemp("tool_inputs")
    d = {k: sim[k] for k in ("snapshot", "membership", "hbt_basename")}
    d["hydro_snapshot"] = make_mock_simulation(str(tmp / "hydro"), n_halos=3, n_field=1200,
                                               boxsize=12.0, seed=10, hydro=True)["snapshot"]
    uni = sim["universe"]
    d["fof"] = str(tmp / "fof.hdf5")
    with h5py.File(d["fof"], "w") as f:
        f["Groups/GroupIDs"] = np.arange(1, uni.n_halos + 1, dtype=np.int64)
        f["Groups/Centres"] = uni.halo_pos
        f["Groups/Sizes"] = uni.halo_nbound.astype(np.int64)
    d["catalogue"] = str(tmp / "lossy.hdf5")
    _lossy_catalogue(d["catalogue"])
    d["packed"] = str(tmp / "packed.hdf5")
    compression.compress_catalogue(d["catalogue"], d["packed"])
    d["lossy_snapshot"] = str(tmp / "lossy_snap.hdf5")
    with compression.open_relaxed(d["lossy_snapshot"], mode="w") as f:
        ds = compression._create_lossy_dataset(
            f, "PartType1/Coordinates", np.random.default_rng(2).random((100, 3)), "DMantissa9", 4)
        ds.attrs["Lossy compression filter"] = np.bytes_("DMantissa9")
    d["filters"] = str(tmp / "filters.yml")
    compression.write_filters_yaml(d["lossy_snapshot"], d["filters"])
    d["timed"] = str(tmp / "timed.hdf5")
    rng = np.random.default_rng(3)
    with h5py.File(d["timed"], "w") as f:
        f["InputHalos/process_time"] = rng.random(40).astype(np.float32)
        f["InputHalos/n_loop"] = rng.integers(1, 4, 40).astype(np.int32)
        f["InputHalos/NumberOfBoundParticles"] = rng.integers(20, 5000, 40).astype(np.uint32)
        for group in ("BoundSubhalo", "SO/200_crit"):
            for name in ("TotalMass", "CentreOfMass"):
                f[f"{group}/{name}_time"] = rng.random(40).astype(np.float32)
    s0, m0 = _mini_snap(tmp / "snap_0.hdf5", 0.4, [10, 11], grnr=[7, -1])
    s1, m1 = _mini_snap(tmp / "snap_1.hdf5", 0.7, [10, 11, 12], grnr=[8, 2, 5])
    d["birth_pairs"] = f"{s0}:{m0},{s1}:{m1}"
    d["birth_final"] = _mini_snap(tmp / "final_snap.hdf5", 1.0, [10, 11, 12],
                                  birth_a=[0.3, 0.6, 0.9])
    d["match"] = [_write_sim(tmp, "a", perm=[0, 1, 2], id_offsets=[5, 6, 7]),
                  _write_sim(tmp, "b", perm=[2, 0, 1], id_offsets=[40, 41, 42])]
    eagle = build_mock_universe(n_halos=4, n_field=2500, boxsize=BOX_HFREE, seed=77,
                                mass_range=(40.0, 200.0))
    d["eagle"] = _write_eagle_mock(tmp, eagle)
    return d


def _match_args(d):
    (s1, m1, c1), (s2, m2, c2) = d["match"]
    return ["--snapshot1", s1, "--membership1", m1, "--catalogue1", c1, "--snapshot2", s2,
            "--membership2", m2, "--catalogue2", c2]


#: per case: the arguments (with ``OUT`` and ``OUT2`` for the outputs),
#: the direct call writing the same outputs, and how an output compares
#: ("h5", or "bytes" for text files; none: the printed line is the output)
TOOL_CASES = {
    "compress": (lambda d: ["compress", d["catalogue"], "OUT"],
                 lambda d, o: compression.compress_catalogue(d["catalogue"], o[0]), "h5"),
    "compress-gzip-filters": (
        lambda d: ["compress", d["catalogue"], "OUT", "--gzip-level", "6", "--filters",
                   d["filters"]],
        lambda d, o: compression.compress_catalogue(d["catalogue"], o[0], 6,
                                                    filters_file=d["filters"]), "h5"),
    "extract-filters": (lambda d: ["extract-filters", d["lossy_snapshot"], "OUT"],
                        lambda d, o: compression.write_filters_yaml(d["lossy_snapshot"], o[0]),
                        "bytes"),
    "compare-same": (lambda d: ["compare", d["catalogue"], d["catalogue"]],
                     lambda d, o: print(compare.compare_catalogues(
                         d["catalogue"], d["catalogue"]).report()), None),
    "compare-packed": (lambda d: ["compare", d["catalogue"], d["packed"]],
                       lambda d, o: print(compare.compare_catalogues(
                           d["catalogue"], d["packed"]).report()), None),
    "compare-packed-exact": (lambda d: ["compare", d["catalogue"], d["packed"], "--exact"],
                             lambda d, o: print(compare.compare_catalogues(
                                 d["catalogue"], d["packed"],
                                 use_compression_tolerance=False).report()), None),
    "property-table-rst": (lambda d: ["property-table", "OUT.rst"],
                           lambda d, o: docs.generate_rst(o[0]), "bytes"),
    "property-table-tex": (lambda d: ["property-table", "OUT.tex"],
                           lambda d, o: docs.generate_latex(o[0]), "bytes"),
    "virtual-snapshot": (lambda d: ["virtual-snapshot", d["snapshot"], d["membership"], "OUT"],
                         lambda d, o: virtual_snapshot.make_virtual_snapshot(
                             d["snapshot"], d["membership"], o[0]), "h5"),
    "empty-catalogue": (lambda d: ["empty-catalogue", d["snapshot"], "OUT"],
                        lambda d, o: virtual_snapshot.create_empty_catalogue(d["snapshot"], o[0]),
                        "h5"),
    "empty-catalogue-dmo": (lambda d: ["empty-catalogue", d["snapshot"], "OUT", "--dmo"],
                            lambda d, o: virtual_snapshot.create_empty_catalogue(
                                d["snapshot"], o[0], True), "h5"),
    "convert-eagle": (lambda d: ["convert-eagle", d["eagle"][0], "OUT", "OUT2",
                                 "--subfind-basename", d["eagle"][1], "--cells-per-dim", "2"],
                      lambda d, o: convert_eagle.convert_eagle(
                          d["eagle"][0], o[0], o[1], subfind_basename=d["eagle"][1],
                          cells_per_dim=2), "h5"),
    "hydrogen-fractions": (lambda d: ["hydrogen-fractions", d["hydro_snapshot"], "OUT"],
                           lambda d, o: hydrogen_phases.compute_hydrogen_fractions(
                               d["hydro_snapshot"], o[0]), "h5"),
    "check-membership": (
        lambda d: ["check-membership", d["snapshot"], d["membership"], d["hbt_basename"],
                   "--halo-format", "HBTplus"],
        lambda d, o: print("membership consistent: {n_labelled}/{n_particles} particles bound "
                           "across {n_halos} halos".format(
                               **membership_checks.check_group_membership(
                                   d["snapshot"], d["membership"], d["hbt_basename"]))), None),
    "birth-halo-index": (lambda d: ["birth-halo-index", d["birth_final"], "OUT", "--snapshots",
                                    d["birth_pairs"]],
                         lambda d, o: membership_checks.compute_birth_halo_index(
                             [tuple(p.split(":")) for p in d["birth_pairs"].split(",")],
                             d["birth_final"], o[0]), "h5"),
    "fof-radii": (lambda d: ["fof-radii", d["snapshot"], d["fof"], "OUT"],
                  lambda d, o: fof_radii.calculate_fof_radii(d["snapshot"], d["fof"], o[0]),
                  "h5"),
    "timing-analysis": (lambda d: ["timing-analysis", d["timed"]],
                        lambda d, o: print(timing_analysis.report(d["timed"])), None),
    "match-halos": (lambda d: ["match-halos", *_match_args(d), "--output", "OUT"],
                    lambda d, o: match_membership.match_group_membership(
                        *d["match"][0], *d["match"][1], o[0]), "h5"),
    "match-halos-flags": (
        lambda d: ["match-halos", *_match_args(d), "--output", "OUT", "--nr-particles", "4",
                   "--match-satellites", "--ptypes", "1"],
        lambda d, o: match_membership.match_group_membership(
            *d["match"][0], *d["match"][1], o[0], ptypes=[1], nr_particles=4,
            match_satellites=True), "h5"),
}


@pytest.mark.parametrize("case", list(TOOL_CASES))
def test_file_subcommand(tool_inputs, tmp_path, capsys, case):
    """The JAX CLI and the port's on the same arguments print the same and
    return the same exit code (compare: 1 where the catalogues differ);
    the port's outputs equal its tool's called directly."""
    argv_of, direct, kind = TOOL_CASES[case]
    argv = argv_of(tool_inputs)
    outs = [str(tmp_path / name) for name in ("out", "out2")]

    def resolve(args, paths):
        names = {"OUT": paths[0], "OUT2": paths[1], "OUT.rst": paths[0] + ".rst",
                 "OUT.tex": paths[0] + ".tex"}
        return [names.get(a, a) for a in args]

    printed = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        rc = main(resolve(argv, outs))
        printed[name] = (rc, capsys.readouterr().out)
    assert printed["port"] == printed["jax"]
    rc = printed["port"][0]
    assert rc == (1 if case == "compare-packed-exact" else 0)
    if kind is None:
        direct(tool_inputs, [])
        assert capsys.readouterr().out == printed["port"][1]
        return
    got = [a for a in resolve(argv, outs) if a.startswith(str(tmp_path))]
    want = [str(tmp_path / f"direct_{os.path.basename(p)}") for p in got]
    direct(tool_inputs, want)
    for g, w in zip(got, want):
        if kind == "h5":
            assert_same_h5(g, w)
        else:
            with open(g, "rb") as a, open(w, "rb") as b:
                assert a.read() == b.read()
