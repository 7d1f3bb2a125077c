"""Documentation generator: property table -> RST / LaTeX.

The port's copy of ``soap_tpu/tools/docs.py`` (reference
``SOAP/property_table.py:5688,5797-5873``): one row per property with
name, shape, dtype, units, description, compression filter, DMO flag,
and which halo types compute it, then the numbered footnotes.  Reads
the port's property table and key lists; no h5py.
"""

from __future__ import annotations

from typing import Optional

from soap_tpu_torch.core.halo_types import halo_type_keys
from soap_tpu_torch.core.registry import footnotes, full_property_table

HALO_TYPES = ("BoundSubhalo", "SO", "Aperture", "ProjectedAperture")
ABBREV = {"BoundSubhalo": "BS", "SO": "SO", "Aperture": "AP", "ProjectedAperture": "PA"}

#: physics footnotes: convention and formula notes attached to property
#: rows.  The footnote -> property mapping is the table's
#: (``core/registry.py::footnotes``); the texts are the JAX tool's.
FOOTNOTE_TEXTS = {
    "footnote_AngMom.tex": "Angular momentum about the centre of potential, in the centre-of-mass velocity frame of the selected particles.",
    "footnote_Ekin.tex": "Kinetic energy in the centre-of-mass frame, including the Hubble-flow term relative to the halo centre.",
    "footnote_Etherm.tex": "Thermal energy = sum of mass times specific internal energy over selected gas.",
    "footnote_MBH.tex": "Properties of the single black hole with the largest subgrid mass in the selection.",
    "footnote_Mnu.tex": "Mnu sums raw neutrino particle masses; MnuNS is the noise-suppressed sum of delta-f weighted masses plus the mean background within the radius.",
    "footnote_SF.tex": "Star-forming gas has StarFormationRates > 0; SWIFT stores the last star-formation scale factor as a negative value for non-star-forming gas, which is excluded.",
    "footnote_Tgas.tex": "Mass-weighted mean gas temperature; no_cool excludes T < 1e5 K, no_agn excludes gas recently heated by AGN (last feedback within 15 Myr and T inside the AGN dT window).",
    "footnote_Xray.tex": "Band-wise sums of the per-particle X-ray luminosities interpolated from the emissivity tables in (z, He fraction, element abundances, T, nH).",
    "footnote_averaged.tex": "Averaged over the two recording windows of the simulation output (e.g. 100 Myr and 10 Myr).",
    "footnote_circvel.tex": "Maximum of the circular velocity sqrt(G M(<r) / r) over particle radii; the soft variant floors radii at the gravitational softening.",
    "footnote_cold_dense.tex": "Cold dense gas: T < 10^4.5 K and hydrogen number density above 0.1 cm^-3 (physical thresholds folded into snapshot units).",
    "footnote_com.tex": "Centre of mass (velocity) of the selected particles; positions are relative to the halo centre of potential and periodic-wrapped.",
    "footnote_compY.tex": "Sum of the per-particle Compton y parameters over selected gas.",
    "footnote_concentration.tex": "NFW concentration from the R1 statistic (mass-weighted mean radius over R_SO) with a correction for mass outside the particle selection; dmo variants use only dark matter.",
    "footnote_coreexcision.tex": "Core-excised variants restrict to radii in [f_ce R_SO, R_SO] (f_ce = 0.15 by default).",
    "footnote_cytemp.tex": "Compton-y-weighted mean gas temperature.",
    "footnote_diffuse.tex": "Diffuse element mass: total element mass minus the part locked in dust grains.",
    "footnote_disc_fraction.tex": "Disc-to-total ratio: fraction of mass with positive specific angular momentum about the angular-momentum axis, mapped to 2 DtoT - 1 in some conventions; here the mass fraction counter-rotation-corrected.",
    "footnote_dopplerB.tex": "Kinetic Sunyaev-Zel'dovich Doppler-b along the line of sight to the lightcone observer position.",
    "footnote_dust.tex": "Dust masses split by grain composition and, where noted, by the hydrogen phase (molecular/atomic) hosting the grains.",
    "footnote_flow_rates.tex": "Flow rates through spherical shells of thickness 0.1 R at R = (0.1, 0.3, 1) x R_SO: sum of m |v_r| / dR (mass), with v_r measured about the CoM velocity inside R and corrected for the pseudo-evolution of R_SO; inflow (v_r < 0) and outflow (v_r > 0) are reported separately, plus fast outflows with v_r > 0.25 Vmax.",
    "footnote_halfmass.tex": "Radius enclosing half the selected mass, interpolated between bracketing particles.",
    "footnote_kappa.tex": "Fraction of kinetic energy in co-rotation: sum of (L_z / m R)^2 kinetic terms over particles with positive L_z about the angular-momentum axis.",
    "footnote_lum.tex": "Luminosities in the 9 GAMA bands (u g r i z Y J H K), dust-free rest-frame values.",
    "footnote_metallicity.tex": "Logarithmic mass-weighted abundance ratios; Low/High limit variants floor the per-particle ratio at the solar value times the stated limit before averaging.",
    "footnote_progenitor_descendant.tex": "Row index of the halo sharing the most bound particles in the adjacent snapshot's catalogue (-1 when absent).",
    "footnote_proj_veldisp.tex": "1D velocity dispersion of the line-of-sight velocity component within the projected aperture.",
    "footnote_satfrac.tex": "Mass fractions of SO particles bound to satellites of the central's FOF group, and to subhalos outside it.",
    "footnote_spectroscopicliketemperature.tex": "Spectroscopic-like temperature: sum(rho m T^0.25) / sum(rho m T^-0.75) over gas with T > 1.16e6 K.",
    "footnote_spin.tex": "Bullock spin parameter: L / (sqrt(2) M V R) at the spherical-overdensity radius.",
    "footnote_tensor.tex": "Inertia tensors as flattened symmetric matrices; iterative variants deform the ellipsoid until convergence, reduced variants weight by 1/r^2.",
    "footnote_veldisp_matrix.tex": "Velocity dispersion matrix: mass-weighted outer product of velocities in the CoM frame (XX YY ZZ XY XZ YZ).",
}


def _footnote_map():
    """property key -> ordered footnote numbers, plus numbered texts."""
    fn = footnotes()
    names = sorted(fn)
    numbers = {name: i + 1 for i, name in enumerate(names)}
    by_key = {}
    for name, keys in fn.items():
        for k in keys:
            by_key.setdefault(k, []).append(numbers[name])
    texts = [(numbers[name], FOOTNOTE_TEXTS.get(name, name)) for name in names]
    return {k: sorted(v) for k, v in by_key.items()}, texts


def _types_for(key: str) -> str:
    keys = halo_type_keys()
    return ",".join(ABBREV[t] for t in HALO_TYPES if key in keys[t])


def generate_rst(output: Optional[str] = None) -> str:
    """reStructuredText list-table of every catalogue property."""
    table = full_property_table()
    lines = [
        "Halo properties",
        "===============",
        "",
        "Each row documents one dataset of the halo catalogue.  The",
        '"types" column lists the halo types computing it: BS =',
        "BoundSubhalo, SO = spherical overdensities, AP = apertures,",
        "PA = projected apertures.",
        "",
        ".. list-table::",
        "   :header-rows: 1",
        "",
        "   * - Name",
        "     - Shape",
        "     - Dtype",
        "     - Units",
        "     - Types",
        "     - Compression",
        "     - DMO",
        "     - Description",
    ]
    fn_by_key, fn_texts = _footnote_map()
    for key in sorted(table.keys(), key=lambda k: table[k].name):
        p = table[key]
        marks = "".join(f" [{n}]_" for n in fn_by_key.get(key, ()))
        lines += [
            f"   * - ``{p.name}``",
            f"     - {p.shape}",
            f"     - {p.dtype}",
            f"     - ``{p.unit}``",
            f"     - {_types_for(key) or '-'}",
            f"     - {p.compression}",
            f"     - {'yes' if p.dmo else 'no'}",
            f"     - {p.description}{marks}",
        ]
    lines += ["", "Notes", "-----", ""]
    for n, text in fn_texts:
        lines.append(f".. [{n}] {text}")
    text = "\n".join(lines) + "\n"
    if output:
        with open(output, "w") as f:
            f.write(text)
    return text


def _tex_escape(s: str) -> str:
    for a, b in (
        ("\\", r"\textbackslash{}"),
        ("&", r"\&"),
        ("%", r"\%"),
        ("#", r"\#"),
        ("_", r"\_"),
        ("^", r"\^{}"),
        ("~", r"\~{}"),
        ("$", r"\$"),
    ):
        s = s.replace(a, b)
    return s


def generate_latex(output: Optional[str] = None) -> str:
    """LaTeX longtable of every catalogue property."""
    table = full_property_table()
    lines = [
        r"\begin{longtable}{p{0.28\textwidth}ccp{0.12\textwidth}cp{0.34\textwidth}}",
        r"\hline",
        r"Name & Shape & Dtype & Units & DMO & Description \\",
        r"\hline",
        r"\endhead",
    ]
    fn_by_key, fn_texts = _footnote_map()
    for key in sorted(table.keys(), key=lambda k: table[k].name):
        p = table[key]
        marks = "".join(
            r"\textsuperscript{" + str(n) + "}"
            for n in fn_by_key.get(key, ())
        )
        lines.append(
            " & ".join(
                [
                    r"\texttt{" + _tex_escape(p.name) + "}" + marks,
                    str(p.shape),
                    _tex_escape(str(p.dtype)),
                    r"\texttt{" + _tex_escape(p.unit) + "}",
                    "yes" if p.dmo else "no",
                    _tex_escape(p.description),
                ]
            )
            + r" \\"
        )
    lines += [r"\hline", r"\end{longtable}", ""]
    for n, text in fn_texts:
        lines.append(
            r"\noindent\textsuperscript{"
            + str(n)
            + "} "
            + _tex_escape(text)
            + r"\\"
        )
    text = "\n".join(lines) + "\n"
    if output:
        with open(output, "w") as f:
            f.write(text)
    return text
