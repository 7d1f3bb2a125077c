"""Static evaluation context shared by all halo-property calculators.

The reference carries this state on ``HaloProperty`` instances
(``SOAP/particle_selection/halo_properties.py:4-35``: unit registry,
critical/mean densities, scale factor, boxsize, per-type softening).  Here
it is a frozen, hashable dataclass of plain Python values: a pure-Python
copy of ``soap_tpu.models.context``, which the port cannot import
(``tests/test_torch_host_mirror.py`` holds the fields and defaults to
the original's).

All values are in *snapshot internal units*; lengths and densities are
PHYSICAL (the kernels work in physical coordinates, matching the
reference's ``.to_physical()`` conversion in ``compute_basics``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

#: Concatenation order of particle types in a halo's padded particle
#: buffer.  Matches the reference's type indices (PartType``i``).
PTYPE_ORDER = (
    "PartType0",  # gas
    "PartType1",  # dark matter
    "PartType4",  # stars
    "PartType5",  # black holes
    "PartType6",  # neutrinos
)

PTYPE_INDEX = {name: int(name[-1]) for name in PTYPE_ORDER}


@dataclass(frozen=True)
class HaloContext:
    """Hashable static context for one snapshot / one chunk."""

    a: float  # scale factor
    z: float  # redshift
    G: float  # Newton's constant, internal units
    boxsize: float  # COMOVING boxsize, internal units
    # physical critical and mean densities, internal units
    critical_density: float
    mean_density: float
    # mean neutrino background density (0 for runs without neutrinos)
    nu_density: float = 0.0
    # Hubble rate at this redshift (internal units) and density parameters,
    # used by the SO shell flow rates (pseudo-evolution correction)
    H: float = 0.0
    omega_m: float = 0.0
    omega_g: float = 0.0
    # recently-heated AGN gas filter (reference
    # ``particle_filter/recently_heated_gas_filter.py:49-173``): gas with
    # LastAGNFeedbackScaleFactors >= a_limit and temperature inside
    # [Tmin, Tmax] is excluded from the *_no_agn properties
    agn_a_limit: float = 2.0  # > 1 disables the filter
    agn_Tmin: float = 0.0
    agn_Tmax: float = float("inf")
    # lightcone observer position (comoving), for DopplerB
    observer_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # named-column metadata (SubgridScheme/NamedColumns) as a hashable
    # tuple of (dataset, (column names...)); reference
    # ``SOAP/core/snapshot_datasets.py:42-198``
    named_columns: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    # parameter-file defined constants (O_H_sun etc.), hashable
    constants: Tuple[Tuple[str, float], ...] = ()
    # cold dense gas filter thresholds (reference
    # ``particle_filter/cold_dense_gas_filter.py:57-77``).  The number
    # density cut n_H > n_min is pre-folded into a PHYSICAL mass-density
    # threshold rho > n_min * m_H in snapshot units (the raw n_min in
    # Mpc^-3 overflows float32); default corresponds to 0.1 cm^-3 in
    # (Mpc, 1e10 Msun) units.
    cold_dense_Tmax: float = 10.0**4.5  # K
    cold_dense_rho_threshold: float = 2.4715e5

    def column_index(self, dataset: str, name: str) -> int:
        """Index of a named column; raises KeyError when unknown."""
        for ds, names in self.named_columns:
            if ds == dataset:
                return names.index(name)
        raise KeyError(f"no named columns for {dataset}")

    def has_column(self, dataset: str, name: str) -> bool:
        for ds, names in self.named_columns:
            if ds == dataset:
                return name in names
        return False

    def constant(self, name: str, default: float = 0.0) -> float:
        for k, v in self.constants:
            if k == name:
                return v
        return default
    # per-included-ptype physical softening lengths, aligned with `ptypes`
    softening: Tuple[float, ...] = ()
    # which particle types are present, in concatenation order
    ptypes: Tuple[str, ...] = ("PartType1",)
    # padded per-ptype candidate capacities, aligned with `ptypes`
    capacities: Tuple[int, ...] = (0,)
    # True when the snapshot is dark-matter-only
    dmo: bool = True

    @property
    def total_capacity(self) -> int:
        return sum(self.capacities)

    def segment(self, ptype: str) -> Tuple[int, int]:
        """(start, stop) of a particle type's rows in the concatenated
        padded buffer; (0, 0) when the type is absent."""
        start = 0
        for name, cap in zip(self.ptypes, self.capacities):
            if name == ptype:
                return start, start + cap
            start += cap
        return 0, 0

    def has_type(self, ptype: str) -> bool:
        return ptype in self.ptypes and self.capacities[self.ptypes.index(ptype)] > 0
