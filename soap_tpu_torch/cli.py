"""Command line: ``python -m soap_tpu_torch <program> ...``.

The port's copy of ``soap_tpu/cli.py`` (reference
``SOAP/core/soap_args.py:26-211``):

    python -m soap_tpu_torch halo-properties <parameter_file.yml> \\
        --sim-name=L1000N0900/DMO_FIDUCIAL --snap-nr=77 [flags]
    python -m soap_tpu_torch membership <parameter_file.yml> \\
        --sim-name=... --snap-nr=77
    python -m soap_tpu_torch recalculate-xrays snap.hdf5 table.hdf5 out.hdf5

or, without a parameter file, with direct paths:

    python -m soap_tpu_torch halo-properties --snapshot snap.hdf5 \\
        --membership mem.hdf5 --halo-basename SubSnap_077 --output out.hdf5

and the JAX CLI's thirteen file subcommands, with its arguments,
defaults, printed lines and exit codes, each running its module of
``soap_tpu_torch/tools/`` on the host (numpy and h5py, no device):
``compress``, ``extract-filters``, ``compare`` (exit code 1 when the
catalogues differ), ``property-table``, ``virtual-snapshot``,
``empty-catalogue``, ``convert-eagle``, ``hydrogen-fractions``,
``check-membership``, ``birth-halo-index``, ``fof-radii``,
``timing-analysis`` and ``match-halos``.

``halo-properties`` and ``recalculate-xrays`` run on ``--device``
(``cuda``, the current card, unless asked for another); for
``halo-properties`` it may be a comma-separated list, over which each
chunk's halo batches are split.  What the JAX package switches with
environment variables is a flag here: ``--no-prefetch`` turns the chunk
loop's read-ahead staging off, ``--io-processes`` reads the snapshot
over worker processes, and ``--batch-rows`` sets the membership join's
batch.  The port reads no environment variable of its own (a multi-host
run takes SLURM's rank when no ``--host-index`` is given).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np

#: where ``--profile`` writes its trace, under the working directory
PROFILE_DIR = "soap_tpu_torch_profile"


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("parameter_file", nargs="?", help="YAML parameter file")
    p.add_argument("--sim-name", help="simulation name for {sim_name} templating")
    p.add_argument("--snap-nr", type=int, help="snapshot number")
    p.add_argument("--snapshot", help="snapshot file (direct path mode)")
    p.add_argument("--membership", help="membership file (direct path mode)")
    p.add_argument("--halo-basename", help="halo catalogue basename")
    p.add_argument("--halo-format", default="HBTplus",
                   help="HBTplus, VR, Gadget4, SubfindEagle or Rockstar (membership: "
                   "HBTplus or VR)")
    p.add_argument("--output", help="output file")
    p.add_argument(
        "--fof-filename",
        help="separate FOF snapshot (overrides Snapshots/fof_filename); "
        "membership files then carry matched FOFGroupIDs",
    )


def _resolve_paths(args):
    """Parameter-file templating or direct paths.

    Returns (snapshot, membership, halo_basename, output, params,
    fof_snapshot, fof_catalogue).  In parameter-file mode the paths get
    the file's ``Parameters`` and ``--sim-name``, and then ``--snap-nr``
    for ``{snap_nr}`` (with its format, as in ``{snap_nr:04d}``);
    ``{file_nr}`` stays for the multi-file layouts.  (The JAX CLI hands
    ``{snap_nr:04d}`` on unexpanded, so its parameter-file mode fails on
    SOAP's templates.)  The FOF snapshot (per-particle
    FOFGroupIDs for membership) comes from ``--fof-filename`` or
    ``Snapshots/fof_filename`` (reference ``group_membership.py:181``);
    the FOF catalogue (group centres and masses for the FOF/* join) from
    ``--fof-group-filename`` or ``HaloFinder/fof_filename`` (reference
    ``soap_args.py:127``)."""
    fof_cli = getattr(args, "fof_filename", None)
    fof_group_cli = getattr(args, "fof_group_filename", None)
    if args.snapshot:
        return (args.snapshot, args.membership or "", args.halo_basename, args.output, None,
                fof_cli, fof_group_cli)
    import yaml

    from soap_tpu_torch.core.params import (
        ParameterFile, _KeepMissingFormatter, substitute_parameters,
    )

    with open(args.parameter_file) as f:
        raw = yaml.safe_load(f)
    raw = substitute_parameters(raw, {"sim_name": args.sim_name or ""})
    params = ParameterFile(parameter_dictionary=raw, snipshot=getattr(args, "snipshot", False))

    def path(section, name, default=""):
        value = raw.get(section, {}).get(name, default) or ""
        return _KeepMissingFormatter().vformat(value, (), {"snap_nr": args.snap_nr})

    snap = path("Snapshots", "filename")
    mem = path("GroupMembership", "filename")
    halo = path("HaloFinder", "filename")
    out = path("HaloProperties", "filename", args.output or "")
    fof = fof_cli or path("Snapshots", "fof_filename") or None
    fof_group = fof_group_cli or path("HaloFinder", "fof_filename") or None
    return snap, mem, halo, out, params, fof, fof_group


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="soap_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    hp = sub.add_parser("halo-properties", help="compute the halo catalogue")
    _add_common(hp)
    hp.add_argument("--dmo", action="store_true", help="dark-matter-only mode")
    hp.add_argument("--centrals-only", action="store_true")
    hp.add_argument("--max-halos", type=int, default=0)
    hp.add_argument(
        "--halo-indices",
        type=lambda s: np.array([int(x) for x in s.split(",")]),
        help="comma-separated catalogue indices (debugging)",
    )
    hp.add_argument(
        "--fof-group-filename",
        help="FOF group catalogue for the FOF/* join (overrides HaloFinder/fof_filename)",
    )
    hp.add_argument("--chunks", type=int, default=1)
    hp.add_argument("--scratch-dir", help="chunk scratch/restart directory")
    hp.add_argument("--host-index", type=int, help="this host's index (multi-host)")
    hp.add_argument("--host-count", type=int, help="number of hosts (multi-host)")
    hp.add_argument(
        "--snipshot",
        action="store_true",
        help="input is a reduced 'snipshot': per-property snapshot/snipshot "
        "filter values from the parameter file apply",
    )
    hp.add_argument(
        "--output-parameters",
        help="write the fully-expanded parameter file here and exit",
    )
    hp.add_argument("--profile", action="store_true",
                    help=f"trace the run with torch.profiler into {PROFILE_DIR}/trace.json")
    hp.add_argument(
        "--reference-snapshot",
        help="lower-z snapshot supplying dataset dtypes/shapes for particle "
        "types absent at high z (reference swift_cells.py:374-404)",
    )
    hp.add_argument(
        "--record-halo-timings",
        action="store_true",
        help="write per-halo process_time/n_loop/n_process datasets into InputHalos",
    )
    hp.add_argument(
        "--record-property-timings",
        action="store_true",
        help="write a <name>_time dataset next to every property (one device "
        "program per calculation, slower: profiling only)",
    )
    hp.add_argument(
        "--device", default="cuda",
        help="torch device, or comma-separated devices to split the halo batches over "
        "(default cuda: the current card)",
    )
    hp.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                    help="stage each chunk after the last one finishes, not ahead of it")
    hp.add_argument("--io-processes", type=int, default=0,
                    help="read the snapshot over this many worker processes")

    mem = sub.add_parser("membership", help="compute group membership files")
    _add_common(mem)
    mem.add_argument("--batch-rows", type=int,
                     help="snapshot rows labelled at a time (default 16Mi)")

    comp = sub.add_parser("compress", help="lossy+gzip compress a catalogue")
    comp.add_argument("input")
    comp.add_argument("compressed_output")
    comp.add_argument("--gzip-level", type=int, default=4)
    comp.add_argument(
        "--filters",
        help="filters YAML from extract-filters: use the exact pipelines "
        "of a SWIFT snapshot instead of synthesized ones",
    )

    ef = sub.add_parser(
        "extract-filters",
        help="extract lossy filter pipelines from a SWIFT snapshot "
        "(reference compression/extract_filters.py)",
    )
    ef.add_argument("snapshot")
    ef.add_argument("output_yaml")

    cmp_p = sub.add_parser("compare", help="compare two catalogues")
    cmp_p.add_argument("catalogue_a")
    cmp_p.add_argument("catalogue_b")
    cmp_p.add_argument("--exact", action="store_true")

    doc = sub.add_parser("property-table", help="generate documentation")
    doc.add_argument("output", help=".rst or .tex output file")

    vs = sub.add_parser("virtual-snapshot", help="snapshot+membership virtual file")
    vs.add_argument("snapshot")
    vs.add_argument("membership_file")
    vs.add_argument("virtual_output")

    ec = sub.add_parser("empty-catalogue", help="zero-halo catalogue")
    ec.add_argument("snapshot")
    ec.add_argument("catalogue_output")
    ec.add_argument("--dmo", action="store_true")

    xr = sub.add_parser(
        "recalculate-xrays",
        help="per-particle X-ray luminosities from an emissivity table "
        "(reference misc/recalculate_xrays.py)",
    )
    xr.add_argument("snapshot")
    xr.add_argument("xray_table")
    xr.add_argument("extra_input_output")
    xr.add_argument("--bands", help="comma-separated band names (default: erosita+ROSAT)")
    xr.add_argument("--device", default="cuda", help="torch device (default cuda)")

    ce = sub.add_parser(
        "convert-eagle",
        help="convert EAGLE GADGET particledata to a SWIFT-layout "
        "snapshot + membership file (reference misc/convert_eagle.py)",
    )
    ce.add_argument("particledata_basename")
    ce.add_argument("output_snapshot")
    ce.add_argument("output_membership")
    ce.add_argument("--subfind-basename")
    ce.add_argument("--cells-per-dim", type=int, default=4)

    hf = sub.add_parser(
        "hydrogen-fractions",
        help="approximate HI/H2 species fractions (Rahmati+13 + BR06; "
        "reference misc/hdecompose_hydrogen_fractions.py)",
    )
    hf.add_argument("snapshot")
    hf.add_argument("extra_input_output")

    cm = sub.add_parser(
        "check-membership",
        help="validate membership files against the halo finder's bound "
        "lists (reference misc/check_group_membership.py)",
    )
    cm.add_argument("snapshot")
    cm.add_argument("membership")
    cm.add_argument("halo_basename")
    cm.add_argument("--halo-format", default="HBTplus")

    bh = sub.add_parser(
        "birth-halo-index",
        help="subhalo each star belonged to when it formed "
        "(reference misc/compute_BirthHaloCatalogueIndex.py)",
    )
    bh.add_argument("final_snapshot")
    bh.add_argument("output")
    bh.add_argument(
        "--snapshots",
        required=True,
        help="comma-separated snapshot:membership file pairs in scale-"
        "factor order, e.g. snap_0.hdf5:mem_0.hdf5,snap_1.hdf5:mem_1.hdf5",
    )

    fr = sub.add_parser(
        "fof-radii",
        help="augment a FOF catalogue with per-group maximum particle "
        "radii (reference misc/calculate_fof_radii.py)",
    )
    fr.add_argument("snapshot")
    fr.add_argument("fof_catalogue")
    fr.add_argument("fof_output")

    ta = sub.add_parser(
        "timing-analysis",
        help="report per-halo timing stats from a catalogue written with "
        "--record-halo-timings (reference misc/plot_time.py)",
    )
    ta.add_argument("catalogue")

    mh = sub.add_parser(
        "match-halos",
        help="match halos across two simulations by bound-particle IDs "
        "(reference misc/match_group_membership.py)",
    )
    for i in ("1", "2"):
        mh.add_argument(f"--snapshot{i}", required=True)
        mh.add_argument(f"--membership{i}", required=True)
        mh.add_argument(f"--catalogue{i}", required=True)
    mh.add_argument("--output", required=True)
    mh.add_argument("--nr-particles", type=int, default=50)
    mh.add_argument("--match-satellites", action="store_true")
    mh.add_argument("--ptypes", default="1", help="comma-separated particle types")
    return parser


def subcommands(parser: argparse.ArgumentParser) -> list:
    """The names of ``parser``'s subcommands, in the order it lists them."""
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return list(action.choices)


def halo_properties_kwargs(args) -> Dict[str, object]:
    """``compute_halo_properties``'s keywords for parsed arguments."""
    snap, mem_file, halo, out, params, _fof, fof_group = _resolve_paths(args)
    return dict(
        snapshot_file=snap,
        membership_file=mem_file,
        halo_basename=halo,
        output_file=out,
        halo_format=args.halo_format,
        parameter_file=params,
        dmo=args.dmo,
        centrals_only=args.centrals_only,
        max_halos=args.max_halos,
        halo_indices=args.halo_indices,
        nr_chunks=args.chunks,
        scratch_dir=args.scratch_dir,
        host_index=args.host_index,
        host_count=args.host_count,
        reference_snapshot=args.reference_snapshot,
        fof_filename=fof_group,
        record_halo_timings=args.record_halo_timings,
        record_property_timings=args.record_property_timings,
        # one device, or a list of them (parallel/sharded.py::local_devices)
        device=args.device.split(",") if "," in args.device else args.device,
        prefetch=args.prefetch,
        io_processes=args.io_processes,
    )


def membership_kwargs(args) -> Dict[str, object]:
    """``run_group_membership``'s keywords for parsed arguments."""
    snap, mem_file, halo, _out, _params, fof, _fof_group = _resolve_paths(args)
    return dict(
        snap_filename=snap,
        halo_basename=args.halo_basename or halo,
        output_filename=args.output or mem_file,
        halo_format=args.halo_format,
        fof_filename=fof,
        batch_rows=args.batch_rows,
        return_labels=False,  # memory-bounded: labels live in the files
    )


def xray_kwargs(args) -> Dict[str, object]:
    """``compute_xray_luminosities``' keywords for parsed arguments."""
    return dict(
        snapshot_file=args.snapshot,
        table_file=args.xray_table,
        output_file=args.extra_input_output,
        bands=args.bands.split(",") if args.bands else None,
        device=args.device,
    )


def _profiled(fn, device: str, trace_dir: str):
    """Run ``fn`` under torch.profiler (CPU, and CUDA on a CUDA device),
    with the program's spans recorded as ranges of the profiler's
    (``utils/trace.py``), and write its Chrome trace into ``trace_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from soap_tpu_torch.utils import trace

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, trace.recording(ranges=True):
        out = fn()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"wrote {path}")
    return out


def run_tool(args) -> int:
    """Run a file subcommand (the JAX CLI's dispatch,
    ``soap_tpu/cli.py:271-394``): its tool, its printed line, its exit
    code."""
    if args.command == "convert-eagle":
        from soap_tpu_torch.tools.convert_eagle import convert_eagle

        counts = convert_eagle(args.particledata_basename, args.output_snapshot,
                               args.output_membership, subfind_basename=args.subfind_basename,
                               cells_per_dim=args.cells_per_dim)
        total = sum(counts.values())
        print(f"wrote {args.output_snapshot} ({total} particles: {counts})")
        return 0
    if args.command == "hydrogen-fractions":
        from soap_tpu_torch.tools.hydrogen_phases import compute_hydrogen_fractions

        compute_hydrogen_fractions(args.snapshot, args.extra_input_output)
        print(f"wrote {args.extra_input_output}")
        return 0
    if args.command == "check-membership":
        from soap_tpu_torch.tools.membership_checks import check_group_membership

        stats = check_group_membership(args.snapshot, args.membership, args.halo_basename,
                                       halo_format=args.halo_format)
        print(f"membership consistent: {stats['n_labelled']}/{stats['n_particles']} particles "
              f"bound across {stats['n_halos']} halos")
        return 0
    if args.command == "birth-halo-index":
        from soap_tpu_torch.tools.membership_checks import compute_birth_halo_index

        pairs = [tuple(p.split(":", 1)) for p in args.snapshots.split(",")]
        out = compute_birth_halo_index(pairs, args.final_snapshot, args.output)
        print(f"wrote {args.output} ({int((out >= 0).sum())}/{len(out)} stars assigned)")
        return 0
    if args.command == "fof-radii":
        from soap_tpu_torch.tools.fof_radii import calculate_fof_radii

        radii = calculate_fof_radii(args.snapshot, args.fof_catalogue, args.fof_output)
        print(f"wrote {args.fof_output} ({len(radii)} groups)")
        return 0
    if args.command == "timing-analysis":
        from soap_tpu_torch.tools.timing_analysis import report

        print(report(args.catalogue))
        return 0
    if args.command == "match-halos":
        from soap_tpu_torch.tools.match_membership import match_group_membership

        out = match_group_membership(
            args.snapshot1, args.membership1, args.catalogue1,
            args.snapshot2, args.membership2, args.catalogue2,
            args.output,
            ptypes=[int(p) for p in args.ptypes.split(",")],
            nr_particles=args.nr_particles,
            match_satellites=args.match_satellites,
        )
        n = int((out["MatchIndex1to2"] >= 0).sum())
        print(f"wrote {args.output} ({n} halos matched 1->2)")
        return 0
    if args.command == "compress":
        from soap_tpu_torch.tools.compression import compress_catalogue

        n = compress_catalogue(args.input, args.compressed_output, args.gzip_level,
                               filters_file=args.filters)
        print(f"compressed {n} datasets")
        return 0
    if args.command == "extract-filters":
        from soap_tpu_torch.tools.compression import write_filters_yaml

        filters = write_filters_yaml(args.snapshot, args.output_yaml)
        print(f"wrote {args.output_yaml} ({', '.join(filters) or 'no filters'})")
        return 0
    if args.command == "compare":
        from soap_tpu_torch.tools.compare import compare_catalogues

        res = compare_catalogues(args.catalogue_a, args.catalogue_b,
                                 use_compression_tolerance=not args.exact)
        print(res.report())
        return 0 if res.identical else 1
    if args.command == "property-table":
        from soap_tpu_torch.tools import docs

        if args.output.endswith(".tex"):
            docs.generate_latex(args.output)
        else:
            docs.generate_rst(args.output)
        print(f"wrote {args.output}")
        return 0
    if args.command == "virtual-snapshot":
        from soap_tpu_torch.tools.virtual_snapshot import make_virtual_snapshot

        make_virtual_snapshot(args.snapshot, args.membership_file, args.virtual_output)
        print(f"wrote {args.virtual_output}")
        return 0
    # empty-catalogue
    from soap_tpu_torch.tools.virtual_snapshot import create_empty_catalogue

    n = create_empty_catalogue(args.snapshot, args.catalogue_output, args.dmo)
    print(f"wrote {args.catalogue_output} ({n} empty datasets)")
    return 0


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "recalculate-xrays":
        from soap_tpu_torch.tools.xray_calculator import compute_xray_luminosities

        out = compute_xray_luminosities(**xray_kwargs(args))
        print(f"wrote {args.extra_input_output} ({', '.join(out)})")
        return 0

    if args.command == "membership":
        from soap_tpu_torch.pipeline.membership import run_group_membership

        run_group_membership(**membership_kwargs(args))
        return 0

    if args.command != "halo-properties":
        return run_tool(args)

    from soap_tpu_torch.pipeline.run import compute_halo_properties

    kwargs = halo_properties_kwargs(args)
    if args.output_parameters:
        # expand the defaults, write the effective parameters and exit
        # (reference --output-parameters, soap_args.py:44-106)
        from soap_tpu_torch.pipeline.specs import build_specs

        params = kwargs["parameter_file"]
        if params is not None:
            build_specs(params, args.dmo, bn98_value=100.0)
            params.write_parameters(args.output_parameters)
            print(f"wrote {args.output_parameters}")
        return 0
    if args.profile:
        _profiled(lambda: compute_halo_properties(**kwargs), args.device.split(",")[0],
                  PROFILE_DIR)
    else:
        compute_halo_properties(**kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
