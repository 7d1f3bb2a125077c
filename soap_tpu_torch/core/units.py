"""Units as static metadata: the catalogue writer's unit attributes.

The port's copy of ``soap_tpu/core/units.py`` (reference
``SOAP/core/swift_units.py``), numpy only: :class:`Unit` (dimension
exponents over SWIFT's five base dimensions ``(I, L, M, T, t)``, a
conversion factor to physical CGS and the folded-in expansion-factor
exponent), :class:`UnitRegistry` (named units from a snapshot's
``Units``, ``InternalCodeUnits`` and ``PhysicalConstants`` groups) and
the converters between SWIFT dataset attributes and :class:`Unit`.
``tests/test_torch_catalogue_host.py`` holds it to the original.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np

DIM_NAMES = ("I", "L", "M", "T", "t")

# CGS definitions used by SWIFT for convenience units.  The actual values
# for a given run are read from the snapshot's PhysicalConstants group; the
# values below are only fallbacks for synthetic data.
_FALLBACK_CONSTANTS = {
    "parsec": 3.08567758149e18,  # cm
    "solar_mass": 1.98841e33,  # g
    "newton_G": 6.67430e-8,  # cm^3 g^-1 s^-2
}


@dataclass(frozen=True)
class Unit:
    """A physical unit: dims over (I, L, M, T, t), CGS factor, a-exponent.

    ``cgs`` converts one of this unit into *physical* CGS, i.e. any
    expansion-factor dependence is already multiplied out.  ``a_exp``
    records the exponent of the expansion factor that was folded in, so the
    comoving conversion factor is ``cgs / a**a_exp``.
    """

    dims: Tuple[float, float, float, float, float]
    cgs: float
    a_exp: float = 0.0

    # ---- algebra ----
    def __mul__(self, other: "Unit") -> "Unit":
        return Unit(
            tuple(a + b for a, b in zip(self.dims, other.dims)),
            self.cgs * other.cgs,
            self.a_exp + other.a_exp,
        )

    def __truediv__(self, other: "Unit") -> "Unit":
        return Unit(
            tuple(a - b for a, b in zip(self.dims, other.dims)),
            self.cgs / other.cgs,
            self.a_exp - other.a_exp,
        )

    def __pow__(self, exp: float) -> "Unit":
        return Unit(
            tuple(a * exp for a in self.dims),
            self.cgs**exp,
            self.a_exp * exp,
        )

    @property
    def dimensionless(self) -> bool:
        return all(d == 0 for d in self.dims)

    def conversion_to(self, other: "Unit") -> float:
        """Factor converting values in ``self`` to values in ``other``.

        Both units must share dimensions.  The factor converts *physical*
        magnitudes; callers deal with comoving/physical conventions via the
        ``a_exp`` metadata explicitly.
        """
        if tuple(self.dims) != tuple(other.dims):
            raise ValueError(
                f"incompatible dimensions {self.dims} vs {other.dims}"
            )
        return self.cgs / other.cgs

    def same_dims(self, other: "Unit") -> bool:
        return tuple(self.dims) == tuple(other.dims)


DIMENSIONLESS = Unit((0.0, 0.0, 0.0, 0.0, 0.0), 1.0, 0.0)


def _base(dim_index: int, cgs: float) -> Unit:
    dims = [0.0] * 5
    dims[dim_index] = 1.0
    return Unit(tuple(dims), cgs, 0.0)


class UnitRegistry:
    """Named units resolved from SWIFT snapshot metadata.

    Mirrors the behaviour of the reference registry builder
    (``SOAP/core/swift_units.py:7-83``): defines ``snap_*`` and ``code_*``
    base units from the ``Units`` / ``InternalCodeUnits`` groups, the
    expansion factor ``a`` and Hubble parameter ``h`` as dimensionless
    scalars, and the convenience units ``swift_mpc`` / ``swift_msun`` /
    ``newton_G`` from the snapshot's physical constants.
    """

    def __init__(
        self,
        snap_units_cgs: Mapping[str, float],
        code_units_cgs: Mapping[str, float],
        a: float,
        h: float,
        constants_cgs: Mapping[str, float] | None = None,
    ):
        self.a = float(a)
        self.h = float(h)
        self.constants_cgs = dict(constants_cgs or {})
        for key, val in _FALLBACK_CONSTANTS.items():
            self.constants_cgs.setdefault(key, val)

        self.units: Dict[str, Unit] = {}
        for prefix, ucgs in (("snap", snap_units_cgs), ("code", code_units_cgs)):
            self.units[f"{prefix}_current"] = _base(
                0, float(ucgs.get("Unit current in cgs (U_I)", 1.0))
            )
            self.units[f"{prefix}_length"] = _base(
                1, float(ucgs["Unit length in cgs (U_L)"])
            )
            self.units[f"{prefix}_mass"] = _base(
                2, float(ucgs["Unit mass in cgs (U_M)"])
            )
            self.units[f"{prefix}_temperature"] = _base(
                3, float(ucgs.get("Unit temperature in cgs (U_T)", 1.0))
            )
            self.units[f"{prefix}_time"] = _base(
                4, float(ucgs["Unit time in cgs (U_t)"])
            )

        pc_cm = self.constants_cgs["parsec"]
        msun_g = self.constants_cgs["solar_mass"]
        self.units["swift_mpc"] = _base(1, 1.0e6 * pc_cm)
        self.units["swift_msun"] = _base(2, msun_g)
        self.units["newton_G"] = Unit(
            (0.0, 3.0, -1.0, 0.0, -2.0), self.constants_cgs["newton_G"], 0.0
        )
        # Common CGS-anchored units for convenience.
        self.units["cm"] = _base(1, 1.0)
        self.units["g"] = _base(2, 1.0)
        self.units["s"] = _base(4, 1.0)
        self.units["K"] = _base(3, 1.0)
        self.units["km/s"] = _base(1, 1.0e5) / _base(4, 1.0)
        self.units["Mpc"] = self.units["swift_mpc"]
        self.units["Msun"] = self.units["swift_msun"]
        self.units["Gyr"] = _base(4, 3.15576e16)
        self.units["dimensionless"] = DIMENSIONLESS
        # The expansion factor as a pseudo-unit: dimensionless, but with a
        # recorded a-exponent so comoving<->physical bookkeeping works.
        self.units["a"] = Unit((0.0,) * 5, self.a, 1.0)

    @classmethod
    def from_snapshot_metadata(cls, meta: "object") -> "UnitRegistry":
        """Build from a snapshot-metadata object (``io/swift_snapshot.py``
        or ``pipeline/run.py::mock_metadata``)."""
        return cls(
            snap_units_cgs=meta.snap_units_cgs,
            code_units_cgs=meta.code_units_cgs,
            a=meta.a,
            h=meta.h,
            constants_cgs=meta.constants_cgs,
        )

    # ---- expression parsing ----
    _TOKEN = re.compile(r"\s*(\*\*|[*/()]|[A-Za-z_]\w*|[-+]?\d+\.?\d*)")

    def parse(self, expr: str) -> Unit:
        """Parse a unit expression like ``snap_mass*snap_length**2/snap_time**2``.

        Supports the grammar used by the reference property table: products,
        quotients, integer/float powers and named units (including names
        containing ``/`` like ``km/s`` when registered verbatim).
        """
        expr = expr.strip()
        if expr in self.units:
            return self.units[expr]
        pos = 0
        tokens = []
        while pos < len(expr):
            m = self._TOKEN.match(expr, pos)
            if not m:
                raise ValueError(f"cannot tokenize unit expression {expr!r}")
            tokens.append(m.group(1))
            pos = m.end()

        def parse_product(i):
            unit, i = parse_power(i)
            while i < len(tokens) and tokens[i] in ("*", "/"):
                op = tokens[i]
                rhs, i = parse_power(i + 1)
                unit = unit * rhs if op == "*" else unit / rhs
            return unit, i

        def parse_power(i):
            base, i = parse_atom(i)
            if i < len(tokens) and tokens[i] == "**":
                exp = float(tokens[i + 1])
                return base**exp, i + 2
            return base, i

        def parse_atom(i):
            tok = tokens[i]
            if tok == "(":
                unit, i = parse_product(i + 1)
                assert tokens[i] == ")"
                return unit, i + 1
            if tok in self.units:
                return self.units[tok], i + 1
            try:
                return Unit((0.0,) * 5, float(tok), 0.0), i + 1
            except ValueError:
                raise ValueError(f"unknown unit {tok!r} in {expr!r}") from None

        unit, i = parse_product(0)
        if i != len(tokens):
            raise ValueError(f"trailing tokens in unit expression {expr!r}")
        return unit

    def __getitem__(self, name: str) -> Unit:
        return self.parse(name)


def unit_from_attributes(attrs: Mapping[str, object], reg: UnitRegistry) -> Unit:
    """Reconstruct a :class:`Unit` from SWIFT dataset attributes.

    Reference semantics: ``SOAP/core/swift_units.py:86-146`` — dimension
    exponents come from ``U_* exponent`` attributes over the *snapshot* base
    units; the a-scale exponent is folded in unless the dataset is marked
    physical.
    """

    def scalar(v):
        arr = np.asarray(v)
        return arr.reshape(-1)[0] if arr.ndim else arr[()]

    unit = DIMENSIONLESS
    for sym, base_name in zip(
        ("I", "L", "M", "T", "t"),
        ("snap_current", "snap_length", "snap_mass", "snap_temperature", "snap_time"),
    ):
        exp = float(scalar(attrs[f"U_{sym} exponent"]))
        if exp != 0.0:
            unit = unit * (reg.units[base_name] ** exp)
    a_exp = float(scalar(attrs["a-scale exponent"]))
    physical = False
    if "Value stored as physical" in attrs:
        physical = int(scalar(attrs["Value stored as physical"])) == 1
    if a_exp != 0.0 and not physical:
        unit = unit * (reg.units["a"] ** a_exp)
    return unit


def attributes_from_unit(
    unit: Unit, physical: bool, a_exp: float | None, reg: UnitRegistry
) -> Dict[str, object]:
    """Generate SWIFT-convention dataset attributes from a :class:`Unit`.

    Mirrors ``SOAP/core/swift_units.py:149-200``: emits both CGS conversion
    factors (with and without cosmological corrections), the five dimension
    exponents, h/a scale exponents and the physical/comoving flags.
    """
    a_in_unit = unit.a_exp
    if a_exp is None:
        assert physical, "a_exp=None implies a physical-only quantity"
    else:
        if physical:
            assert a_in_unit == 0, "physical outputs must carry no a-factor"
        else:
            assert float(a_in_unit) == float(a_exp)

    cgs_physical = unit.cgs
    a_val = reg.a
    attrs: Dict[str, object] = {}
    attrs["Conversion factor to CGS (not including cosmological corrections)"] = [
        float(cgs_physical / (a_val**a_in_unit))
    ]
    attrs[
        "Conversion factor to physical CGS (including cosmological corrections)"
    ] = [float(cgs_physical)]
    for i, sym in enumerate(DIM_NAMES):
        attrs[f"U_{sym} exponent"] = [float(unit.dims[i])]
    attrs["h-scale exponent"] = [0.0]
    attrs["a-scale exponent"] = [0.0 if a_exp is None else float(a_exp)]
    attrs["Value stored as physical"] = [1 if physical else 0]
    attrs["Property can be converted to comoving"] = [0 if a_exp is None else 1]
    return attrs
