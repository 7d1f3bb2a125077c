"""The halo-type calculations the port runs.

``slice_specs`` is the spec set of the DMO engine slice: the bound
subhalo's masses, centres, half-mass radius and iterative inertia
tensors, and the centrals' SO/200_crit radius, mass, centre and
iterative inertia tensor.  It reaches both kernels in every bucket: the
range gather, and the inertia loop twice (bound: two configs; SO: one
config with the search-radius check that feeds the retry ladder).
"""

from __future__ import annotations

from typing import List

from soap_tpu_torch.pipeline.engine import HaloTypeSpec


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
