"""The halo-properties entry: inputs in, SOAP catalogue out.

The port's copy of ``soap_tpu/pipeline/run.py``, for the five halo
finders (``HALO_FORMATS``), on one device or a list of them, in two
halves:

- ``build_catalogue`` (torch and numpy only; runs on the card): from a
  snapshot-metadata object, a ``HaloCatalogue``, the particle fields
  (every cell's, or a chunk reader) and the spec list, it runs the
  engine over the run's Peano–Hilbert chunks (``pipeline/chunks.py::
  process_chunks``: read-ahead staging, scratch files and restart, a
  host's share of a multi-host run and the combine), the category
  filters, ``drop_disabled_keys``, the spatial sort and, for HBTplus
  catalogues, the derived ``SOAP/*`` columns, and returns the sorted,
  unit-annotated ``io/catalogue.py::Catalogue``, with per-halo and
  per-property timings when asked;
- ``compute_halo_properties`` (the JAX signature): reads the SWIFT
  snapshot's metadata, the membership file and the finder's catalogues
  (``io/halo_catalogue.py::CATALOGUE_READERS``), calls
  ``build_catalogue`` with a file reader and writes the catalogue and
  the ``SOAP.used_parameters.yml`` mirror.  Only this half opens
  files; h5py and yaml are imported inside the functions that do (the
  scratch files of ``scratch_dir`` are files too).

``make_context`` turns snapshot metadata into the engine's
``HaloContext`` (a parameter file sets the recently-heated and cold
dense gas filters and the defined constants); ``mock_metadata`` and
``mock_catalogue`` give a mock universe's metadata and catalogue as the
JAX readers read them back from its written files, without a file.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from soap_tpu_torch.core.category_filter import DEFAULT_FILTERS, CategoryFilter
from soap_tpu_torch.core.cosmology import Cosmology
from soap_tpu_torch.core.params import ParameterFile
from soap_tpu_torch.core.registry import full_property_table
from soap_tpu_torch.core.units import UnitRegistry
from soap_tpu_torch.io.catalogue import Catalogue, make_catalogue, spatial_sort_order
from soap_tpu_torch.io.fof_catalogue import fof_join
from soap_tpu_torch.io.halo_catalogue import (
    CATALOGUE_READERS, HaloCatalogue, hbtplus_catalogue,
)
from soap_tpu_torch.io.swift_snapshot import mask_cells_for_spheres
from soap_tpu_torch.models.context import HaloContext
from soap_tpu_torch.parallel import multihost
from soap_tpu_torch.pipeline import derived
from soap_tpu_torch.pipeline.chunks import (
    ChunkRecord, file_reader, memory_reader, process_chunks,
)
from soap_tpu_torch.pipeline.engine import EngineStats, HaloTypeSpec, min_physical_radius
from soap_tpu_torch.pipeline.specs import build_specs
from soap_tpu_torch.utils import mock_data, trace

#: default solar abundance ratios (a parameter file's defined_constants
#: override them)
DEFAULT_CONSTANTS = {
    "O_H_sun": 4.9e-4,
    "Fe_H_sun": 2.82e-5,
    "N_O_sun": 0.138,
    "C_O_sun": 0.549,
    "Mg_H_sun": 3.98e-5,
}

#: Julian seconds per Myr
_MYR_S = 3.15576e13
#: hydrogen mass (g), for the cold dense gas filter's density threshold
_M_H_G = 1.67262192369e-24


@dataclass
class SnapshotInfo:
    """The snapshot metadata the entry reads (``make_context``,
    ``required_datasets``, the sort and the catalogue), by the attribute
    names of the JAX package's ``SnapshotMetadata``
    (``io/swift_snapshot.py`` reads them from a file); every value is in
    snapshot units."""

    a: float
    z: float
    h: float
    boxsize: float  # comoving
    cosmology_attrs: Dict[str, float]
    snap_units_cgs: Dict[str, float]
    constants_cgs: Dict[str, float]
    cosmology: Cosmology
    critical_density: float  # physical
    mean_density: float  # physical
    virBN98: float
    dark_matter_softening: float  # physical
    baryon_softening: float
    nu_softening: float
    AGN_delta_T: float  # K
    observer_position: np.ndarray  # comoving
    named_columns: Dict[str, list]
    ptypes: list
    datasets: Dict[str, Dict[str, Tuple[int, ...]]]  # ptype -> name -> row shape
    header: Dict[str, object]  # the Header group's attributes, as stored
    parameters: Dict[str, object]  # the Parameters group's, as stored
    code_units_cgs: Dict[str, float]
    nr_cells: int
    dimension: np.ndarray  # (3,) top-level cells per dimension
    cell_size: np.ndarray  # (3,) comoving
    cell_centres: np.ndarray  # (nr_cells, 3) comoving
    units: UnitRegistry

    def mask_cells_for_spheres(self, centres, radii, select=None) -> np.ndarray:
        """``io/swift_snapshot.py::mask_cells_for_spheres`` over these cells."""
        return mask_cells_for_spheres(
            self.cell_centres, self.cell_size, self.boxsize, centres, radii, select)


#: datasets the membership pass adds to every particle type
MEMBERSHIP_DATASETS = {"GroupNr_bound": (), "Rank_bound": ()}


def mock_metadata(uni: mock_data.MockUniverse) -> SnapshotInfo:
    """The metadata the JAX package reads back from this universe's mock
    snapshot and its membership file, derived as ``SnapshotMetadata``
    derives it (snapshot and code units coincide, so every conversion
    factor is 1)."""
    attrs = mock_data.snapshot_attrs(uni)
    cosmo_attrs = attrs["Cosmology"]
    cosmology = Cosmology.from_attrs(cosmo_attrs)
    par = mock_data.MOCK_PARAMETERS
    a = float(cosmo_attrs["Scale-factor"])

    def soft(comoving, physical):
        return min(par.get(comoving, 0.0) * a, par.get(physical, 0.0))

    dm = {
        "Coordinates": uni.pos, "Velocities": uni.vel, "Masses": uni.mass,
        "ParticleIDs": uni.ids, "FOFGroupIDs": uni.fof_ids,
    }
    datasets = {}
    for ptype, fields in (("PartType1", dm),) + tuple((uni.extra_ptypes or {}).items()):
        datasets[ptype] = {
            name: tuple(np.asarray(arr).shape[1:]) for name, arr in fields.items()
        }
    for names in datasets.values():
        names.update(MEMBERSHIP_DATASETS)
    used = {name for names in datasets.values() for name in names}
    n = mock_data.MOCK_CELLS_PER_DIM
    units = UnitRegistry(attrs["Units"], attrs["Units"], a, float(cosmo_attrs["h"]),
                         attrs["PhysicalConstants/CGS"])
    return SnapshotInfo(
        a=a,
        z=1.0 / a - 1.0,
        h=float(cosmo_attrs["h"]),
        boxsize=float(uni.boxsize),
        cosmology_attrs=dict(cosmo_attrs),
        snap_units_cgs=dict(attrs["Units"]),
        constants_cgs=dict(attrs["PhysicalConstants/CGS"]),
        cosmology=cosmology,
        critical_density=float(cosmo_attrs["Critical density [internal units]"]),
        mean_density=cosmology.mean_density_internal(
            attrs["PhysicalConstants/InternalUnits"]["newton_G"]
        ),
        virBN98=cosmology.bn98_virial_multiple(),
        dark_matter_softening=soft(
            "Gravity:comoving_DM_softening", "Gravity:max_physical_DM_softening"
        ),
        baryon_softening=soft(
            "Gravity:comoving_baryon_softening", "Gravity:max_physical_baryon_softening"
        ),
        nu_softening=soft(
            "Gravity:comoving_nu_softening", "Gravity:max_physical_nu_softening"
        ),
        AGN_delta_T=float(par.get("EAGLEAGN:AGN_delta_T_K", 0.0)),
        observer_position=np.full(3, 0.5 * uni.boxsize),
        named_columns={k: list(v) for k, v in mock_data.NAMED_COLUMNS.items() if k in used},
        ptypes=sorted(datasets),
        datasets=datasets,
        header=mock_data.snapshot_header(uni),
        parameters={k: np.bytes_(v) for k, v in sorted(mock_data.MOCK_PARAMETER_TEXT.items())},
        code_units_cgs=dict(attrs["Units"]),
        nr_cells=n**3,
        dimension=np.full(3, n, dtype=np.int64),
        cell_size=np.full(3, uni.boxsize / n),
        cell_centres=mock_data.cell_centres(uni.boxsize, n),
        units=units,
    )


def mock_catalogue(uni: mock_data.MockUniverse) -> HaloCatalogue:
    """The catalogue ``read_hbtplus_catalogue`` reads back from this
    universe's HBTplus file as the JAX package's mock writer writes it
    (Mpc/h and Msun/h in float32, unit factors 1)."""
    n = uni.n_halos
    zeros_i32 = np.zeros(n, np.int32)
    subs = {
        "TrackId": np.asarray(uni.halo_track, np.int64),
        "Nbound": np.asarray(uni.halo_nbound, np.int64),
        "Rank": np.asarray(uni.halo_rank).astype(np.int64),
        "HostHaloId": np.asarray(uni.halo_host, np.int64),
        "Depth": np.asarray(uni.halo_depth).astype(np.int32),
        "ComovingMostBoundPosition": (uni.halo_pos * uni.h).astype(np.float32),
        "PhysicalAverageVelocity": np.zeros((n, 3), np.float32),
        "REncloseComoving": (uni.halo_renclose * uni.h).astype(np.float32),
        "NestedParentTrackId": np.full(n, -1, np.int64),
        "DescendantTrackId": np.full(n, -1, np.int64),
        "LastMaxMass": (uni.halo_nbound * uni.mass[0] * 1.0e10 * uni.h).astype(np.float32),
        "LastMaxVmaxPhysical": np.full(n, 100.0, np.float32),
        "SnapshotOfBirth": zeros_i32,
        "SnapshotOfLastMaxMass": zeros_i32,
        "SnapshotOfLastMaxVmax": zeros_i32,
        "SnapshotOfLastIsolation": zeros_i32,
    }
    return hbtplus_catalogue(subs, float(uni.h))


def make_context(
    meta, ptypes: Sequence[str], dmo: bool, parameter_file: Optional[ParameterFile] = None
) -> HaloContext:
    """HaloContext from snapshot metadata (physical snapshot units), with
    the filters and constants of ``parameter_file`` (defaults without)."""
    # recently-heated AGN gas: a_limit such that the lookback time to it
    # is delta_time_in_Myr (15); the AGN heating temperature sets the
    # [dT 10^delta_logT_min, dT 10^delta_logT_max] window
    agn_a_limit, agn_Tmin, agn_Tmax = 2.0, 0.0, float("inf")
    rh = parameter_file.recently_heated_gas_params() if parameter_file else {}
    H0_internal = float(meta.cosmology_attrs.get("H0 [internal units]", 0.0))
    if H0_internal > 0:
        delta_myr = float(rh.get("delta_time_in_Myr", 15.0))
        delta_internal = delta_myr * _MYR_S / meta.snap_units_cgs["Unit time in cgs (U_t)"]
        age_a, age_h0 = meta.cosmology.age_table()
        ages_internal = age_h0 / H0_internal
        t_now = np.interp(meta.a, age_a, ages_internal)
        agn_a_limit = float(np.interp(t_now - delta_internal, ages_internal, age_a))
        if rh.get("use_AGN_delta_T", True) and meta.AGN_delta_T > 0:
            agn_Tmin = meta.AGN_delta_T * 10.0 ** float(rh.get("delta_logT_min", -1.0))
            agn_Tmax = meta.AGN_delta_T * 10.0 ** float(rh.get("delta_logT_max", 0.3))
    # cold dense gas: float() as YAML 1.1 reads "3.16e4" as a string
    cold = (
        parameter_file.get_parameters().get("calculations", {}).get("cold_dense_gas_filter", {})
        if parameter_file else {}
    )
    constants = {**DEFAULT_CONSTANTS,
                 **(parameter_file.get_defined_constants() if parameter_file else {})}
    ul = meta.snap_units_cgs["Unit length in cgs (U_L)"]
    um = meta.snap_units_cgs["Unit mass in cgs (U_M)"]
    ut = meta.snap_units_cgs["Unit time in cgs (U_t)"]
    G_snap = meta.constants_cgs["newton_G"] * um * ut**2 / ul**3
    soft = []
    for pt in ptypes:
        if pt == "PartType1":
            soft.append(meta.dark_matter_softening)
        elif pt == "PartType6":
            soft.append(meta.nu_softening)
        else:
            soft.append(meta.baryon_softening)
    # mean neutrino background density (physical): Omega_nu_0 rho_crit0 / a^3
    nu_density = 0.0
    omega_nu = float(meta.cosmology_attrs.get("Omega_nu_0", 0.0))
    if omega_nu:
        rho_crit0 = meta.critical_density / float(meta.cosmology.E(np.array(meta.a)) ** 2)
        nu_density = omega_nu * rho_crit0 / meta.a**3
    return HaloContext(
        a=meta.a,
        z=meta.z,
        G=G_snap,
        boxsize=meta.boxsize,
        critical_density=meta.critical_density,
        mean_density=meta.mean_density,
        nu_density=nu_density,
        H=float(meta.cosmology_attrs.get("H [internal units]", 0.0)),
        omega_m=float(meta.cosmology_attrs.get("Omega_m", 0.0)),
        omega_g=float(meta.cosmology_attrs.get("Omega_g", 0.0)),
        agn_a_limit=agn_a_limit,
        agn_Tmin=agn_Tmin,
        agn_Tmax=agn_Tmax,
        observer_position=tuple(float(v) for v in meta.observer_position),
        # n_H > n_min as a physical mass density in snapshot units
        cold_dense_rho_threshold=(
            float(cold.get("minimum_hydrogen_number_density_cm3", 0.1)) * _M_H_G * ul**3 / um
        ),
        cold_dense_Tmax=float(cold.get("maximum_temperature_K", 10.0**4.5)),
        named_columns=tuple(
            (f"{pt}/{ds}", tuple(cols))
            for ds, cols in sorted(meta.named_columns.items())
            for pt in meta.ptypes
            if ds in meta.datasets.get(pt, {})
        ),
        constants=tuple(sorted(constants.items())),
        softening=tuple(soft),
        ptypes=tuple(ptypes),
        capacities=tuple(0 for _ in ptypes),
        dmo=dmo,
    )


def age_table(meta) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The a -> age table in internal time units, as float32 (None
    without H0): what the JAX run hands its chunk staging."""
    H0_internal = float(meta.cosmology_attrs.get("H0 [internal units]", 0.0))
    if H0_internal <= 0:
        return None
    age_a, age_h0 = meta.cosmology.age_table()
    return age_a.astype(np.float32), (age_h0 / H0_internal).astype(np.float32)


# ----------------------------------------------------------------------
# The entry: category filters, sort, derived columns, catalogue
# ----------------------------------------------------------------------

#: output group prefix -> parameter-file base halo type (reference
#: ``category_filter.py:158-165``)
GROUP_TO_BASE = {
    "BoundSubhalo": "SubhaloProperties",
    "SO": "SOProperties",
    "ExclusiveSphere": "ApertureProperties",
    "InclusiveSphere": "ApertureProperties",
    "ProjectedAperture": "ProjectedApertureProperties",
}

#: the halo finders the entry reads
HALO_FORMATS = tuple(CATALOGUE_READERS)


def _check_halo_format(halo_format: str) -> None:
    if halo_format not in HALO_FORMATS:
        raise ValueError(
            f"halo_format {halo_format!r}: the entry reads {', '.join(HALO_FORMATS)}")


def apply_category_filters(
    results: Dict[str, Dict[str, np.ndarray]],
    cat_filter: CategoryFilter,
    parameter_file: Optional[ParameterFile],
    n_halos: int,
    specs: Optional[Sequence[HaloTypeSpec]] = None,
) -> tuple:
    """Zero out masked halos in place; return (dataset_attrs, group_attrs).

    Two masking levels, both from BoundSubhalo particle counts: each
    property's category from the parameter file (by output name), in its
    dataset's ``Masked`` / ``Mask *`` attributes, and each spec's
    ``halo_filter``, which zeroes its whole group for the halos failing
    it and is recorded in the group's attributes."""
    masks = cat_filter.category_masks(results.get("BoundSubhalo", {}), n_halos)
    attrs: Dict[str, Dict[str, object]] = {}
    group_attrs: Dict[str, Dict[str, object]] = {}
    table = full_property_table()
    halo_filters = {s.group: s.halo_filter for s in (specs or ())}
    for group, props in results.items():
        base = GROUP_TO_BASE.get(group.split("/")[0])
        categories: Dict[str, object] = {}
        if parameter_file is not None and base is not None:
            categories = parameter_file.get_property_filters(
                base, [table[k].name for k in props.keys()]
            )
        halo_filter = halo_filters.get(group, "basic")
        group_attrs[group] = cat_filter.filter_metadata(
            halo_filter if halo_filter != "basic" else None
        )
        halo_mask = masks.get(halo_filter)
        for key in list(props):
            name = table[key].name
            category = categories.get(name, "basic")
            if category is False or not isinstance(category, str):
                category = "basic"
            attrs[f"{group}/{name}"] = cat_filter.filter_metadata(category)
            mask = masks.get(category, masks["basic"])
            if halo_mask is not None:
                mask = mask & halo_mask
            if not mask.all():
                arr = props[key]
                keep = mask.reshape((-1,) + (1,) * (arr.ndim - 1))
                props[key] = np.where(keep, arr, 0)
    return attrs, group_attrs


def drop_disabled_keys(
    results: Dict[str, Dict[str, np.ndarray]], parameter_file: Optional[ParameterFile]
) -> None:
    """Remove the properties the parameter file disables (``build_specs``
    computes the BoundSubhalo counts the filters need even so)."""
    if parameter_file is None:
        return
    table = full_property_table()
    for group, props in results.items():
        base = GROUP_TO_BASE.get(group.split("/")[0])
        chosen = parameter_file.property_filters.get(base or "", {})
        for key in [k for k in props if chosen.get(table[k].name) is False]:
            del props[key]


def entry_plan(
    meta, dmo: bool, parameter_file: Optional[ParameterFile] = None,
    specs: Optional[Sequence[HaloTypeSpec]] = None,
) -> Tuple[List[str], List[HaloTypeSpec]]:
    """The particle types a run stages (those with datasets; dark matter
    and neutrinos only when ``dmo``) and its spec list (``specs``, or the
    parameter file's, or the defaults): what the host fields handed to
    ``build_catalogue`` must cover."""
    ptypes = [pt for pt in meta.ptypes if pt in meta.datasets and meta.datasets[pt]]
    if dmo:
        ptypes = [pt for pt in ptypes if pt in ("PartType1", "PartType6")]
    if specs is None:
        specs = build_specs(parameter_file, dmo, bn98_value=meta.virBN98)
    return ptypes, list(specs)


def select_halos(
    cat: HaloCatalogue,
    halo_indices: Optional[np.ndarray] = None,
    centrals_only: bool = False,
    max_halos: int = 0,
) -> HaloCatalogue:
    """The reference's debugging selections, in its order: the listed
    catalogue indices, centrals, the first ``max_halos``."""
    if halo_indices is not None:
        cat = cat.select(np.isin(cat.index, np.asarray(halo_indices)))
    if centrals_only:
        cat = cat.select(cat.is_central)
    if max_halos and cat.nr_halos > max_halos:
        keep = np.zeros(cat.nr_halos, bool)
        keep[:max_halos] = True
        cat = cat.select(keep)
    return cat


def _git_hash() -> str:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                cwd=__file__.rsplit("/", 3)[0],
            ).stdout.strip()
            or "unknown"
        )
    except Exception:
        return "unknown"


def _progress(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class EntryResult:
    """What a run of the entry returns: the catalogue (None on a host of
    a multi-host run that did not combine), the filtered engine results
    in catalogue (unsorted) order (a multi-host combiner's columns are
    read from the scratch files on access), the halos, the spatial sort
    order, the engine's counters and context, one record per chunk, and
    the seconds spent on the host before the chunk loop (selections,
    context), waiting in it for reads and staging, in the engine, and
    after it (filters, sort, derived columns, catalogue)."""

    catalogue: Optional[Catalogue]
    results: Dict[str, Dict[str, np.ndarray]]
    halos: HaloCatalogue
    order: np.ndarray
    stats: EngineStats
    ctx: HaloContext
    prep_seconds: float
    stage_seconds: float
    engine_seconds: float
    post_seconds: float
    chunks: List[ChunkRecord]
    output_path: Optional[str] = None


def build_catalogue(
    meta,
    cat: HaloCatalogue,
    host,
    specs: Sequence[HaloTypeSpec],
    parameter_file: Optional[ParameterFile] = None,
    dmo: bool = True,
    device="cuda",
    centrals_only: bool = False,
    max_halos: int = 0,
    halo_indices: Optional[np.ndarray] = None,
    min_read_radius_mpc: float = 5.0e-3,
    prev_catalogue: Optional[HaloCatalogue] = None,
    next_catalogue: Optional[HaloCatalogue] = None,
    fof_groups: Optional[Dict[str, np.ndarray]] = None,
    snapshot_file: str = "",
    membership_file: str = "",
    halo_basename: str = "",
    halo_format: str = "HBTplus",
    nr_chunks: int = 1,
    scratch_dir: Optional[str] = None,
    host_index: Optional[int] = None,
    host_count: Optional[int] = None,
    record_halo_timings: bool = False,
    record_property_timings: bool = False,
    prefetch: bool = True,
    verbose: bool = False,
) -> EntryResult:
    """The in-memory half of the entry, on ``device``: one device
    (``"cuda"``: the current card), or a list of them (a device may
    repeat), as ``parallel/sharded.py::local_devices`` reads it.  Over a
    list each chunk's store is replicated on every device and its halo
    batches split over them, with results equal to one device's.

    ``meta`` is a snapshot-metadata object (``mock_metadata`` or
    ``io/swift_snapshot.py::SnapshotMetadata``), ``cat`` the halo
    catalogue.  ``host`` is either every cell's particle fields per type
    (as ``pipeline/chunks.py::mock_fields`` or ``read_chunk_fields``
    give them for ``entry_plan``'s types and this spec list), staged
    whole with one chunk and through ``chunks.memory_reader`` with more,
    or a chunk reader ``read(rows)`` over the rows of the selected
    catalogue (``chunks.file_reader``).

    ``nr_chunks`` Peano–Hilbert chunks run one after another, with
    read-ahead staging unless ``prefetch`` is off; ``scratch_dir`` keeps
    one scratch file per chunk and reuses the valid ones.  A host of a
    multi-host run (``host_index`` of ``host_count``; by default from
    ``parallel/multihost.py::detect_host_rank``) computes its
    round-robin share of the chunks into ``scratch_dir``; the first host
    to find them all complete claims the combine and builds the
    catalogue, the others return theirs without one.
    ``record_halo_timings`` adds ``InputHalos/process_time``, ``n_loop``
    and ``n_process``; ``record_property_timings`` runs every spec as
    its own program and adds a ``<property>_time`` dataset per property.
    The selections, the adjacent catalogues (``SOAP/ProgenitorIndex``,
    ``SOAP/DescendantIndex``), the SWIFT FOF groups (``FOF/*``) and the
    input names recorded under ``Parameters`` are as in the JAX
    ``compute_halo_properties``; the ``SOAP/*`` and ``FOF/*`` columns come
    only with an HBTplus catalogue (its ``HostHaloId`` and ``TrackId``).
    A ``halo_format`` outside ``HALO_FORMATS`` raises ValueError."""
    _check_halo_format(halo_format)
    t_start = time.perf_counter()
    prep = trace.start("entry.prep", t_start)
    cat = select_halos(cat, halo_indices, centrals_only, max_halos)

    # the search radius floor: the parameter file's min_read_radius_cmpc
    # (comoving Mpc) overrides the keyword, and the largest fixed physical
    # radius of any spec floors it
    cmpc = (
        parameter_file.get_parameters().get("calculations", {}).get("min_read_radius_cmpc")
        if parameter_file is not None else None
    )
    if cmpc is not None:
        min_read_radius_mpc = float(cmpc) * meta.a
    search_radius_phys = np.maximum(
        np.maximum(cat.search_radius * meta.a, min_read_radius_mpc), min_physical_radius(specs)
    )
    ptypes, specs = entry_plan(meta, dmo, parameter_file, specs)
    if callable(host):
        read_chunk = host
    else:
        if sorted(host) != sorted(ptypes):
            raise ValueError(f"host fields for {sorted(host)}, the run stages {ptypes}")
        fields = {pt: host[pt] for pt in ptypes}
        read_chunk = (
            (lambda rows: fields) if nr_chunks == 1
            else memory_reader(meta, cat, fields, specs)
        )
    ctx = make_context(meta, ptypes, dmo, parameter_file)

    # a multi-host run: this host's round-robin share of the chunks
    if host_index is None and host_count is None:
        host_index, host_count = multihost.detect_host_rank()
    chunk_subset = None
    if host_count and host_count > 1:
        if not scratch_dir:
            raise ValueError("a multi-host run needs a scratch_dir")
        chunk_subset = multihost.chunks_for_host(nr_chunks, host_index or 0, host_count)
        if verbose:
            _progress(f"host {host_index}/{host_count}: chunks {chunk_subset}")

    t0 = time.perf_counter()
    prep.stop(t0)
    results, stats, records = process_chunks(
        read_chunk, cat, ctx, specs, search_radius_phys, device, nr_chunks=nr_chunks,
        scratch_dir=scratch_dir, chunk_subset=chunk_subset, prefetch=prefetch,
        record_halo_timings=record_halo_timings,
        record_property_timings=record_property_timings, verbose=verbose,
    )
    t_post = time.perf_counter()
    post = trace.start("entry.post", t_post)
    stage_seconds = sum(r.wait_seconds for r in records)
    engine_seconds = sum(r.engine_seconds for r in records)

    def uncombined(reason: str) -> EntryResult:
        post.stop()
        if verbose:
            _progress(reason)
        return EntryResult(
            catalogue=None, results=results, halos=cat, order=np.arange(cat.nr_halos),
            stats=stats, ctx=ctx, prep_seconds=t0 - t_start, stage_seconds=stage_seconds,
            engine_seconds=engine_seconds, post_seconds=0.0, chunks=records)

    if chunk_subset is not None and (host_index != 0 or len(chunk_subset) < nr_chunks):
        # exactly one host combines and builds the catalogue: the first
        # to find every scratch file complete claims it (O_EXCL lock)
        try:
            multihost.check_scratch_complete(scratch_dir, specs, cat.nr_halos)
        except (FileNotFoundError, RuntimeError) as e:
            return uncombined(f"skipping combine ({e}); partial results only")
        if not multihost.claim_combine(scratch_dir):
            return uncombined("another host claimed the combine; partial results only "
                           "(delete combine.lock to re-run)")
        try:
            results = multihost.combine_scratch(scratch_dir, specs, cat.nr_halos, lazy=True)
        except (FileNotFoundError, RuntimeError) as e:
            multihost.release_combine(scratch_dir)
            return uncombined(f"skipping combine ({e}); partial results only")
        if verbose:
            _progress("combined all hosts' scratch files (combine claimed)")

    # --- category filters: zero masked halos, record metadata ---
    cat_filter = CategoryFilter(
        parameter_file.get_filters(DEFAULT_FILTERS) if parameter_file else None, dmo=dmo
    )
    filter_attrs, group_attrs = apply_category_filters(
        results, cat_filter, parameter_file, cat.nr_halos, specs
    )
    drop_disabled_keys(results, parameter_file)

    cells_per_dim = int(meta.dimension[0])
    order = spatial_sort_order(cat.cofp, cat.index, meta.boxsize, cells_per_dim)

    # --- derived SOAP/* columns, computed in final (sorted) order and
    # mapped back to unsorted storage for the catalogue's [order] ---
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(len(order))
    soap_cols: Dict[str, np.ndarray] = {}
    # the derived columns read HBTplus TrackIds and host haloes; the other
    # finders' catalogues get none, as in the JAX entry
    if "HBTplus/HostHaloId" in cat.passthrough:
        host_fof = cat.passthrough["HBTplus/HostHaloId"]
        host_fof_sorted = host_fof[order]
        soap_cols["SOAP/HostHaloIndex"] = derived.host_halo_index(
            host_fof_sorted, cat.is_central.astype(bool)[order])[inv_order]
        track_sorted = cat.passthrough["HBTplus/TrackId"][order]
        if "BoundSubhalo" in results and "Mtot" in results["BoundSubhalo"]:
            soap_cols["SOAP/SubhaloRankByBoundMass"] = derived.subhalo_rank_by_bound_mass(
                host_fof_sorted, track_sorted, results["BoundSubhalo"]["Mtot"][order]
            )[inv_order]
        # FOF group join for centrals (``combine_chunks.py:406-535``)
        if fof_groups is not None:
            soap_cols.update(fof_join(fof_groups, host_fof, cat.is_central.astype(bool)))
        # mass-binned reduced-snapshot sampling (``combine_chunks.py:606-674``)
        rs_params = (
            parameter_file.get_parameters().get("calculations", {}).get("reduced_snapshots")
            if parameter_file else None
        )
        if rs_params and "SO/200_crit" in results:
            msun_per_unit = meta.snap_units_cgs["Unit mass in cgs (U_M)"] / 1.98841e33
            soap_cols["SOAP/IncludedInReducedSnapshot"] = derived.included_in_reduced_snapshot(
                results["SO/200_crit"]["Mtot"][order] * msun_per_unit,
                halos_per_bin=int(rs_params["halos_per_bin"]),
                bin_size_dex=float(rs_params["halo_bin_size_dex"]),
                min_halo_mass_msun=float(rs_params["min_halo_mass"]),
            )[inv_order]
        # progenitor/descendant rows: TrackId matched against the adjacent
        # snapshots' spatially sorted catalogues (``combine_chunks.py:676-735``)
        for name, other in (("SOAP/ProgenitorIndex", prev_catalogue),
                            ("SOAP/DescendantIndex", next_catalogue)):
            other_sorted = None
            if other is not None:
                o_order = spatial_sort_order(
                    other.cofp, other.index, meta.boxsize, cells_per_dim)
                other_sorted = other.passthrough["HBTplus/TrackId"][o_order]
            soap_cols[name] = derived.progenitor_descendant_index(
                track_sorted, other_sorted)[inv_order]

    input_halos = {
        "cofp": cat.cofp,
        "index": cat.index,
        "is_central": cat.is_central.astype(np.int64),
        "nr_bound_part": cat.nr_bound_part,
        **cat.passthrough,
        **soap_cols,
    }
    timings = stats.halo_timings() if record_halo_timings else None
    if timings is not None:
        # per-halo timing datasets (reference ``--record-halo-timings``,
        # ``halo_centres.py:183-218``): seconds, bucket rounds, and
        # whether this run processed the halo (not from scratch)
        pos = {int(i): p for p, i in enumerate(timings["index"])}
        rows = np.array([pos.get(int(i), -1) for i in cat.index], dtype=np.int64)
        ok = rows >= 0
        input_halos["process_time"] = np.zeros(cat.nr_halos, np.float32)
        input_halos["n_loop"] = np.zeros(cat.nr_halos, np.int32)
        input_halos["process_time"][ok] = timings["process_time"][rows[ok]]
        input_halos["n_loop"][ok] = timings["n_loop"][rows[ok]]
        input_halos["n_process"] = ok.astype(np.int32)
    property_timings = None
    if record_property_timings and stats.spec_halo_chunks:
        # per-group per-halo seconds: one ``_time`` dataset per property
        property_timings = {}
        pos_of = {int(i): p for p, i in enumerate(cat.index)}
        for group, tmap in stats.property_timings().items():
            arr = np.zeros(cat.nr_halos, np.float32)
            for i, sec in tmap.items():
                if int(i) in pos_of:
                    arr[pos_of[int(i)]] = sec
            property_timings[group] = arr
    catalogue = make_catalogue(
        meta,
        meta.units,
        results,
        input_halos,
        order,
        git_hash=_git_hash(),
        dataset_extra_attrs=filter_attrs,
        group_attrs=group_attrs,
        property_timings=property_timings,
        run_parameters={
            "swift_filename": snapshot_file,
            "membership_filename": membership_file or "",
            "halo_basename": halo_basename,
            "halo_format": halo_format,
            "centrals_only": int(centrals_only),
            "calculations": sorted(s.group for s in specs),
            "halo_indices": (
                np.asarray(halo_indices, dtype=np.int64)
                if halo_indices is not None else np.zeros(0, dtype=np.int64)
            ),
        },
    )
    t_end = time.perf_counter()
    post.stop(t_end)
    return EntryResult(
        catalogue=catalogue, results=results, halos=cat, order=order, stats=stats, ctx=ctx,
        prep_seconds=t0 - t_start, stage_seconds=stage_seconds, engine_seconds=engine_seconds,
        post_seconds=t_end - t_post, chunks=records,
    )


def compute_halo_properties(
    snapshot_file: str,
    membership_file: str,
    halo_basename: str,
    output_file: Optional[str],
    halo_format: str = "HBTplus",
    parameter_file: Optional[ParameterFile] = None,
    dmo: bool = True,
    centrals_only: bool = False,
    max_halos: int = 0,
    halo_indices: Optional[np.ndarray] = None,
    min_read_radius_mpc: float = 5.0e-3,
    specs: Optional[List[HaloTypeSpec]] = None,
    nr_chunks: int = 1,
    scratch_dir: Optional[str] = None,
    prev_halo_basename: Optional[str] = None,
    next_halo_basename: Optional[str] = None,
    fof_filename: Optional[str] = None,
    host_index: Optional[int] = None,
    host_count: Optional[int] = None,
    reference_snapshot: Optional[str] = None,
    record_halo_timings: bool = False,
    record_property_timings: bool = False,
    verbose: bool = True,
    device="cuda",
    prefetch: bool = True,
    io_processes: int = 0,
) -> EntryResult:
    """The file half of the entry: one snapshot, on ``device`` as
    ``build_catalogue`` takes it (one device, or a list to split over).

    Reads the snapshot's metadata (with the membership file as extra
    input) and the catalogue of ``halo_format``, one of ``HALO_FORMATS``
    (HBTplus, VR, Gadget4, SubfindEagle, Rockstar; any other name raises
    ValueError before anything is read or written), and for an HBTplus
    catalogue, when named, the adjacent snapshots' catalogues (a missing
    one is skipped) and the SWIFT FOF groups; runs ``build_catalogue``
    with a reader of the snapshot's cells (``chunks.file_reader``; over
    ``io_processes`` worker processes when more than one) on ``device``,
    with its chunk, scratch, multi-host and timing options; writes
    ``output_file`` and, with a parameter file, ``SOAP.used_parameters.yml``
    beside it, unless this host did not combine.  A multi-host run splits
    the chunks over the hosts, and each host's chunks use all of its
    ``device``."""
    from soap_tpu_torch.io.catalogue_writer import write_catalogue
    from soap_tpu_torch.io.fof_catalogue import read_fof_groups
    from soap_tpu_torch.io.swift_snapshot import SnapshotMetadata

    _check_halo_format(halo_format)
    t0 = time.time()
    meta = SnapshotMetadata(
        snapshot_file, [membership_file] if membership_file else [],
        ref_filename=reference_snapshot,
    )
    read = CATALOGUE_READERS[halo_format]
    cat = read(halo_basename, h=meta.h, a=meta.a)
    ptypes, specs = entry_plan(meta, dmo, parameter_file, specs)
    selected = select_halos(cat, halo_indices, centrals_only, max_halos)
    reader = file_reader(meta, selected, specs, ptypes, age_table(meta), io_processes)

    # the adjacent catalogues and the FOF groups feed only the SOAP/* and
    # FOF/* columns, which need an HBTplus catalogue
    hbtplus = "HBTplus/HostHaloId" in cat.passthrough
    adjacent = {}
    for name, basename in (("prev", prev_halo_basename), ("next", next_halo_basename)):
        adjacent[name] = None
        if basename and hbtplus:
            try:
                adjacent[name] = read(basename, h=meta.h, a=meta.a)
            except FileNotFoundError:
                if verbose:
                    _progress(f"no adjacent catalogue for the {name} snapshot: {basename}")
    run = build_catalogue(
        meta, selected, reader, specs, parameter_file, dmo, device=device,
        centrals_only=centrals_only, max_halos=max_halos, halo_indices=halo_indices,
        min_read_radius_mpc=min_read_radius_mpc,
        prev_catalogue=adjacent["prev"], next_catalogue=adjacent["next"],
        fof_groups=read_fof_groups(fof_filename) if fof_filename and hbtplus else None,
        snapshot_file=snapshot_file, membership_file=membership_file,
        halo_basename=halo_basename, halo_format=halo_format,
        nr_chunks=nr_chunks, scratch_dir=scratch_dir, host_index=host_index,
        host_count=host_count, record_halo_timings=record_halo_timings,
        record_property_timings=record_property_timings, prefetch=prefetch,
        verbose=verbose,
    )
    if verbose:
        _progress(f"[{time.time()-t0:6.1f}s] processed {run.stats.halos_done} halos in "
                  f"{run.stats.n_bucket_calls} bucket calls ({run.stats.n_retries} retries) "
                  f"over {len(run.chunks)} chunks")
    if run.catalogue is None:
        return run
    if output_file and parameter_file is not None:
        # mirror of SWIFT's .used_parameters output
        parameter_file.write_parameters(os.path.join(
            os.path.dirname(os.path.abspath(output_file)), "SOAP.used_parameters.yml"))
    if output_file:
        write_catalogue(output_file, run.catalogue)
        run.output_path = output_file
        if verbose:
            _progress(f"[{time.time()-t0:6.1f}s] wrote {output_file}")
    return run
