"""The port's command line, ``python -m soap_tpu_torch``, on the CPU.

``halo-properties`` in direct-path mode and in parameter-file mode (a
copy of MINIMAL_FLAMINGO's file with the mock's paths, templated with
``{sim_dir}``, ``{sim_name}`` and ``{snap_nr:04d}``), ``membership
--halo-format VR`` and ``recalculate-xrays``, each run as its own
process with ``--device cpu`` where it takes one, write what the
function they call writes when called directly; every flag maps onto its
keyword (with ``cuda`` the default device); ``--profile`` writes a
torch.profiler trace.
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

from soap_tpu.pipeline.membership import run_group_membership as jax_membership
from soap_tpu.utils.mock_data import make_mock_simulation
from soap_tpu_torch import cli
from soap_tpu_torch.core.params import ParameterFile, substitute_parameters
from soap_tpu_torch.io.catalogue_writer import read_catalogue
from soap_tpu_torch.io.halo_catalogue import read_hbtplus_catalogue, read_hbtplus_groupnr
from soap_tpu_torch.pipeline.membership import run_group_membership
from soap_tpu_torch.pipeline.run import compute_halo_properties
from soap_tpu_torch.tools import xray_calculator as xc
from soap_tpu_torch.utils import mock_finders
from soap_tpu_torch.utils.parity import catalogue_differences

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
    ``soap_tpu_torch_profile/`` under the working directory and still
    writes the catalogue."""
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
    assert read_catalogue(out).n_halos == 2
