"""The halo-type calculations the port runs.

``build_specs(params, dmo, bn98_value)`` is the port's copy of
``soap_tpu/pipeline/specs.py::build_specs`` (reference
``SOAP/compute_halo_properties.py:224-511``): BoundSubhalo, then the SO
variations (plain before radius multiples; core-excised and fixed-radius
ones from a parameter file), the 3D apertures (property-sized ones
first, then kind-major and radius-minor with their copy links), and the
projected apertures (property-sized ones first, then axis-major and
radius-minor).  ``params`` None gives the default production list; a
``ParameterFile`` its variations, disabled properties and
``strict_halo_copy``.

``slice_specs`` is the small spec set of the engine's first slice: the
bound subhalo's masses, centres, half-mass radius and iterative inertia
tensors, and the centrals' SO/200_crit radius, mass, centre and
iterative inertia tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from soap_tpu_torch.core.halo_types import halo_type_keys, implemented_keys_for
from soap_tpu_torch.core.params import ParameterFile
from soap_tpu_torch.core.registry import full_property_table
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


def _enabled_keys(
    params: Optional[ParameterFile], base_halo_type: str, keys: Tuple[str, ...]
) -> Tuple[str, ...]:
    """The keys the parameter file leaves enabled: it lists properties by
    output name; a property set to ``false`` is not computed, an unlisted
    one follows ``calculate_missing_properties``."""
    if params is None:
        return tuple(keys)
    table = full_property_table()
    names = [table[k].name for k in keys]
    filters = params.get_property_filters(base_halo_type, names)
    return tuple(k for k, n in zip(keys, names) if filters[n] is not False)


def _variations(params: Optional[ParameterFile], base_halo_type: str, default: Dict) -> Dict:
    if params is None:
        return dict(default)
    return params.get_halo_type_variations(base_halo_type, default)


def _radius_property(cfg: Dict) -> Tuple[str, str, float]:
    """(source group, source key, multiple) of a property-sized aperture,
    from its ``property: <group>/<output name>``."""
    src_group, src_output = cfg["property"].rsplit("/", 1)
    src_key = full_property_table().by_output_name(src_output).key
    return src_group, src_key, float(cfg.get("radius_multiple", 1.0))


def build_specs(
    params: Optional[ParameterFile],
    dmo: bool,
    bn98_value: float,
    subhalo: bool = True,
    so: bool = True,
    apertures: bool = True,
    projected: bool = True,
) -> List[HaloTypeSpec]:
    """The ordered spec list of a parameter file, or of the default
    variations when ``params`` is None."""
    specs: List[HaloTypeSpec] = []

    if subhalo:
        all_sub = implemented_keys_for("BoundSubhalo", dmo)
        sub_keys = _enabled_keys(params, "SubhaloProperties", all_sub)
        # the category filters read the bound particle counts: they stay
        # computed when disabled (the writer drops disabled keys)
        count_keys = tuple(
            k for k in ("Ngas", "Ndm", "Nstar", "Nbh") if k in all_sub and k not in sub_keys
        )
        specs.append(HaloTypeSpec(kind="bound", group="BoundSubhalo", keys=sub_keys + count_keys))

    if so:
        variations = _variations(params, "SOProperties", DEFAULT_SO_VARIATIONS)
        so_keys = _enabled_keys(params, "SOProperties", implemented_keys_for("SO", dmo))
        plain = {n: c for n, c in variations.items() if not c.get("radius_multiple")}
        multiples = {n: c for n, c in variations.items() if c.get("radius_multiple")}
        ce_keys = _enabled_keys(
            params, "SOProperties", implemented_keys_for("CoreExcisedSO", dmo)
        )
        for name, cfg in plain.items():
            keys = so_keys
            if cfg.get("core_excision_fraction"):
                # a core-excised SO: the SO list plus the excised extras
                keys = tuple(so_keys) + tuple(k for k in ce_keys if k not in so_keys)
            so_type, value = cfg["type"], float(cfg.get("value", 0.0))
            if so_type == "BN98":
                value = bn98_value
            if "radius_in_kpc" in cfg:
                # a fixed physical radius (Mpc in so_multiple)
                so_type, value = "physical", float(cfg["radius_in_kpc"]) / 1000.0
            specs.append(
                HaloTypeSpec(
                    kind="SO", group=f"SO/{name}", keys=keys, so_type=so_type,
                    so_multiple=value,
                    core_excision_fraction=cfg.get("core_excision_fraction"),
                    centrals_only=True, halo_filter=cfg.get("filter", "basic"),
                )
            )
        for name, cfg in multiples.items():
            # e.g. 5xR500_crit: a multiple of the parent SO's radius
            parent = next(
                (
                    f"SO/{pname}" for pname, pcfg in plain.items()
                    if pcfg["type"] == cfg["type"]
                    and float(pcfg.get("value", -1)) == float(cfg.get("value", -2))
                ),
                None,
            )
            if parent is None:
                raise ValueError(f"radius-multiple SO {name} has no parent SO variation")
            specs.append(
                HaloTypeSpec(
                    kind="SO", group=f"SO/{name}", keys=so_keys,
                    so_type=cfg["type"], so_multiple=float(cfg.get("value", 0.0)),
                    radius_multiple_of=parent,
                    radius_multiple=float(cfg["radius_multiple"]),
                    centrals_only=True, halo_filter=cfg.get("filter", "basic"),
                )
            )

    if apertures:
        variations = _variations(params, "ApertureProperties", DEFAULT_APERTURE_VARIATIONS)
        ap_keys = _enabled_keys(params, "ApertureProperties", implemented_keys_for("Aperture", dmo))
        strict = params.strict_halo_copy() if params else False
        rad_dep = tuple(k for k in halo_type_keys()["ApertureRadiusDependent"] if k in ap_keys)
        # apertures sized by an earlier property (N x <output name>) come
        # first, outside the copy chains of the fixed radii
        for cfg in (c for c in variations.values() if "property" in c):
            radius_property = _radius_property(cfg)
            inclusive = bool(cfg.get("inclusive", False))
            prefix = "InclusiveSphere" if inclusive else "ExclusiveSphere"
            src_output = cfg["property"].rsplit("/", 1)[1]
            specs.append(
                HaloTypeSpec(
                    kind="aperture",
                    group=f"{prefix}/{int(radius_property[2])}x{src_output}",
                    keys=ap_keys, inclusive=inclusive, radius_property=radius_property,
                    halo_filter=cfg.get("filter", "basic"),
                )
            )
        prev_by_kind: Dict[bool, Optional[Tuple[str, float]]] = {True: None, False: None}
        # kind-major, radius-minor: each kind's radii are one consecutive
        # family.  Exclusive spheres copy from the next-smaller one;
        # inclusive spheres only with skip_gt_enclose_radius.
        for cfg in sorted(
            (c for c in variations.values() if "property" not in c),
            key=lambda c: (bool(c.get("inclusive", False)), float(c["radius_in_kpc"])),
        ):
            r_kpc = float(cfg["radius_in_kpc"])
            inclusive = bool(cfg.get("inclusive", False))
            prefix = "InclusiveSphere" if inclusive else "ExclusiveSphere"
            prev = prev_by_kind[inclusive]
            can_copy = prev is not None and (
                not inclusive or bool(cfg.get("skip_gt_enclose_radius"))
            )
            group = f"{prefix}/{_aperture_name(r_kpc)}"
            specs.append(
                HaloTypeSpec(
                    kind="aperture", group=group, keys=ap_keys,
                    aperture_radius_mpc=r_kpc / 1000.0, inclusive=inclusive,
                    copy_from=prev[0] if can_copy else None,
                    copy_from_radius_mpc=prev[1] if can_copy else None,
                    strict_keys=rad_dep if strict else (),
                    halo_filter=cfg.get("filter", "basic"),
                )
            )
            prev_by_kind[inclusive] = (group, r_kpc / 1000.0)

    if projected:
        variations = _variations(
            params, "ProjectedApertureProperties", DEFAULT_PROJECTED_VARIATIONS
        )
        pr_keys = _enabled_keys(
            params, "ProjectedApertureProperties",
            implemented_keys_for("ProjectedAperture", dmo),
        )
        strict = params.strict_halo_copy() if params else False
        pr_rad_dep = tuple(
            k for k in halo_type_keys()["ProjectedApertureRadiusDependent"] if k in pr_keys
        )
        for cfg in (c for c in variations.values() if "property" in c):
            radius_property = _radius_property(cfg)
            src_output = cfg["property"].rsplit("/", 1)[1]
            for axis, label in enumerate("xyz"):
                specs.append(
                    HaloTypeSpec(
                        kind="projected",
                        group=f"ProjectedAperture/{int(radius_property[2])}x{src_output}"
                              f"/proj{label}",
                        keys=pr_keys, axis=axis, radius_property=radius_property,
                        halo_filter=cfg.get("filter", "basic"),
                    )
                )
        radii_sorted = sorted(
            (c for c in variations.values() if "property" not in c),
            key=lambda c: float(c["radius_in_kpc"]),
        )
        # axis-major, radius-minor: one family per axis
        for axis, label in enumerate("xyz"):
            prev = None
            for cfg in radii_sorted:
                r_kpc = float(cfg["radius_in_kpc"])
                group = f"ProjectedAperture/{_aperture_name(r_kpc)}/proj{label}"
                specs.append(
                    HaloTypeSpec(
                        kind="projected", group=group, keys=pr_keys,
                        aperture_radius_mpc=r_kpc / 1000.0, axis=axis,
                        copy_from=prev[0] if prev else None,
                        copy_from_radius_mpc=prev[1] if prev else None,
                        strict_keys=pr_rad_dep if strict else (),
                        halo_filter=cfg.get("filter", "basic"),
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

