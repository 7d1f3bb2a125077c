"""The halo-type calculations the port runs.

``build_specs(None, dmo, bn98_value)`` is the default production list of
``soap_tpu/pipeline/specs.py::build_specs`` (reference
``SOAP/compute_halo_properties.py:224-511``): BoundSubhalo, then the SO
variations (plain before radius multiples), the 3D apertures
kind-major and radius-minor with their copy links, and the projected
apertures axis-major and radius-minor.  Parameter files are not ported.

``slice_specs`` is the small spec set of the engine's first slice: the
bound subhalo's masses, centres, half-mass radius and iterative inertia
tensors, and the centrals' SO/200_crit radius, mass, centre and
iterative inertia tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from soap_tpu_torch.core.halo_types import implemented_keys_for
from soap_tpu_torch.pipeline.engine import HaloTypeSpec

DEFAULT_SO_VARIATIONS = {
    "200_mean": {"value": 200.0, "type": "mean"},
    "50_crit": {"value": 50.0, "type": "crit"},
    "100_crit": {"value": 100.0, "type": "crit"},
    "200_crit": {"value": 200.0, "type": "crit"},
    "500_crit": {"value": 500.0, "type": "crit"},
    "1000_crit": {"value": 1000.0, "type": "crit"},
    "2500_crit": {"value": 2500.0, "type": "crit"},
    "BN98": {"value": 0.0, "type": "BN98"},
    "5xR500_crit": {"value": 500.0, "type": "crit", "radius_multiple": 5.0},
}

DEFAULT_APERTURE_VARIATIONS = {
    f"{kind}_{r}_kpc": {"radius_in_kpc": float(r), "inclusive": kind == "inclusive"}
    for kind in ("inclusive", "exclusive")
    for r in (10, 30, 50, 100, 300, 500, 1000, 3000)
}

DEFAULT_PROJECTED_VARIATIONS = {
    f"{r}_kpc": {"radius_in_kpc": float(r)} for r in (10, 30, 50, 100)
}


def _aperture_name(r_kpc: float) -> str:
    """Sub-kpc radii are named in parsecs (300pc, 100pc, ...)."""
    if r_kpc < 1.0:
        return f"{1000.0 * r_kpc:.0f}pc"
    return f"{r_kpc:.0f}kpc"


def build_specs(
    params,
    dmo: bool,
    bn98_value: float,
    subhalo: bool = True,
    so: bool = True,
    apertures: bool = True,
    projected: bool = True,
) -> List[HaloTypeSpec]:
    """The ordered spec list of the default variations (``params`` None)."""
    if params is not None:
        raise NotImplementedError("parameter files are not ported; pass None")
    specs: List[HaloTypeSpec] = []

    if subhalo:
        specs.append(
            HaloTypeSpec(
                kind="bound", group="BoundSubhalo",
                keys=implemented_keys_for("BoundSubhalo", dmo),
            )
        )

    if so:
        so_keys = implemented_keys_for("SO", dmo)
        variations = dict(DEFAULT_SO_VARIATIONS)
        plain = {n: c for n, c in variations.items() if not c.get("radius_multiple")}
        multiples = {n: c for n, c in variations.items() if c.get("radius_multiple")}
        for name, cfg in plain.items():
            value = bn98_value if cfg["type"] == "BN98" else float(cfg["value"])
            specs.append(
                HaloTypeSpec(
                    kind="SO", group=f"SO/{name}", keys=so_keys,
                    so_type=cfg["type"], so_multiple=value, centrals_only=True,
                )
            )
        for name, cfg in multiples.items():
            # e.g. 5xR500_crit: a multiple of the parent SO's radius
            parent = next(
                f"SO/{pname}" for pname, pcfg in plain.items()
                if pcfg["type"] == cfg["type"]
                and float(pcfg["value"]) == float(cfg["value"])
            )
            specs.append(
                HaloTypeSpec(
                    kind="SO", group=f"SO/{name}", keys=so_keys,
                    so_type=cfg["type"], so_multiple=float(cfg["value"]),
                    radius_multiple_of=parent,
                    radius_multiple=float(cfg["radius_multiple"]),
                    centrals_only=True,
                )
            )

    if apertures:
        ap_keys = implemented_keys_for("Aperture", dmo)
        prev_by_kind: Dict[bool, Optional[Tuple[str, float]]] = {True: None, False: None}
        # kind-major, radius-minor: each kind's radii are one consecutive
        # family.  Exclusive spheres copy from the next-smaller one;
        # inclusive spheres only on a parameter file's request.
        for _, cfg in sorted(
            DEFAULT_APERTURE_VARIATIONS.items(),
            key=lambda kv: (bool(kv[1]["inclusive"]), float(kv[1]["radius_in_kpc"])),
        ):
            r_kpc = float(cfg["radius_in_kpc"])
            inclusive = bool(cfg["inclusive"])
            prefix = "InclusiveSphere" if inclusive else "ExclusiveSphere"
            prev = prev_by_kind[inclusive]
            can_copy = prev is not None and not inclusive
            group = f"{prefix}/{_aperture_name(r_kpc)}"
            specs.append(
                HaloTypeSpec(
                    kind="aperture", group=group, keys=ap_keys,
                    aperture_radius_mpc=r_kpc / 1000.0, inclusive=inclusive,
                    copy_from=prev[0] if can_copy else None,
                    copy_from_radius_mpc=prev[1] if can_copy else None,
                )
            )
            prev_by_kind[inclusive] = (group, r_kpc / 1000.0)

    if projected:
        pr_keys = implemented_keys_for("ProjectedAperture", dmo)
        radii = sorted(
            float(c["radius_in_kpc"]) for c in DEFAULT_PROJECTED_VARIATIONS.values()
        )
        # axis-major, radius-minor: one family per axis
        for axis, label in enumerate("xyz"):
            prev = None
            for r_kpc in radii:
                group = f"ProjectedAperture/{_aperture_name(r_kpc)}/proj{label}"
                specs.append(
                    HaloTypeSpec(
                        kind="projected", group=group, keys=pr_keys,
                        aperture_radius_mpc=r_kpc / 1000.0, axis=axis,
                        copy_from=prev[0] if prev else None,
                        copy_from_radius_mpc=prev[1] if prev else None,
                    )
                )
                prev = (group, r_kpc / 1000.0)
    return specs


def slice_specs() -> List[HaloTypeSpec]:
    return [
        HaloTypeSpec(
            kind="bound",
            group="BoundSubhalo",
            keys=(
                "Mtot", "Ndm", "com", "vcom", "HalfMassRadiusTot",
                "TotalInertiaTensor", "TotalInertiaTensorReduced",
            ),
        ),
        HaloTypeSpec(
            kind="SO",
            group="SO/200_crit",
            keys=("r", "Mtot", "Ndm", "com", "TotalInertiaTensor"),
            so_type="crit",
            so_multiple=200.0,
            centrals_only=True,
        ),
    ]

