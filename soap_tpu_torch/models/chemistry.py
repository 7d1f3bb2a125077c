"""Element chemistry, species and dust properties (a mixin of HaloSlice).

Ported from ``soap_tpu/models/chemistry.py`` (reference
``SOAP/particle_selection/aperture_properties.py:2000-3500``): hydrogen,
helium, HI and H2 masses and half-mass radii, diffuse element masses,
dust grain species masses (in atomic, molecular and cold dense gas),
cold dense gas masses, and the linear and logarithmic mass-weighted
abundance ratios with their solar-relative floors.

Column indices come from the snapshot's named-column metadata on the
``HaloContext``; a dataset or column the snapshot lacks gives zeros.
Every property is per halo, (B,); the gas and star helpers of
``HaloSlice`` (``_gas_sel``, ``_gas_mass``, ``field``, ...) give
segment-local (B, K_t) arrays.
"""

from __future__ import annotations

import torch

from soap_tpu_torch.models.lazy import lazy_property as _lazy
from soap_tpu_torch.ops import radii as radii_ops
from soap_tpu_torch.ops.reductions import masked_sum


class ChemistryMixin:
    """Gas and star chemistry lazy properties (see the module docstring)."""

    # ---- named columns, segment-local; None when absent ----

    def _column(self, ds: str, name: str):
        if not (self._has(ds) and self.ctx.has_column(ds, name)):
            return None
        return self.field(ds)[..., self.ctx.column_index(ds, name)]

    def _elem(self, ptype: str, element: str):
        return self._column(f"{ptype}/ElementMassFractions", element)

    def _elem_diffuse(self, element: str):
        return self._column("PartType0/ElementMassFractionsDiffuse", element)

    def _species(self, name: str):
        return self._column("PartType0/SpeciesFractions", name)

    def _dust_col(self, name: str):
        return self._column("PartType0/DustMassFractions", name)

    def _gas_sum(self, values, extra_mask=None):
        if values is None:
            return self._zeros()
        mask = self._gas_sel if extra_mask is None else self._gas_sel & extra_mask
        return masked_sum(values, mask)

    # ---- hydrogen / helium / species masses ----

    @_lazy
    def HydrogenMass(self):
        e = self._elem("PartType0", "Hydrogen")
        return self._gas_sum(None if e is None else self._gas_mass * e)

    @_lazy
    def HeliumMass(self):
        e = self._elem("PartType0", "Helium")
        return self._gas_sum(None if e is None else self._gas_mass * e)

    @_lazy
    def _gas_HI_frac(self):
        """HI mass per unit gas mass: X_H * SpeciesFractions[HI]."""
        h, s = self._elem("PartType0", "Hydrogen"), self._species("HI")
        return None if h is None or s is None else h * s

    @_lazy
    def _gas_H2_frac(self):
        """H2 mass per unit gas mass (two H atoms per molecule)."""
        h, s = self._elem("PartType0", "Hydrogen"), self._species("H2")
        return None if h is None or s is None else 2.0 * h * s

    @_lazy
    def AtomicHydrogenMass(self):
        f = self._gas_HI_frac
        return self._gas_sum(None if f is None else self._gas_mass * f)

    @_lazy
    def MolecularHydrogenMass(self):
        f = self._gas_H2_frac
        return self._gas_sum(None if f is None else self._gas_mass * f)

    @_lazy
    def HalfMassRadiusAtomicHydrogen(self):
        return self._half_mass_radius_gas_weighted(
            self._gas_HI_frac, self.AtomicHydrogenMass, "_w_HI_sorted"
        )

    @_lazy
    def HalfMassRadiusMolecularHydrogen(self):
        return self._half_mass_radius_gas_weighted(
            self._gas_H2_frac, self.MolecularHydrogenMass, "_w_H2_sorted"
        )

    def _half_mass_radius_gas_weighted(self, frac, total, seeded=None):
        """Half-weight radius of gas weighted by mass x ``frac`` on the
        profile sort: the shared radius sort's payload when the engine
        seeded it (never on projected slices, whose profile order differs),
        else a gather of the weights."""
        if frac is None:
            return self._zeros()
        w_sorted = self.__dict__.get(seeded) if seeded else None
        if w_sorted is None:
            w_sorted = self._full_from_gas(self._gas_mass * frac).gather(1, self._prof_order)
        return radii_ops.half_weight_radius_sorted(
            self._prof_r_sorted, w_sorted, self._prof_gas_sorted, total
        )

    # ---- diffuse element masses (dust excluded) ----

    def _diffuse_mass(self, element):
        e = self._elem_diffuse(element)
        return self._gas_sum(None if e is None else self._gas_mass * e)

    @_lazy
    def DiffuseCarbonMass(self):
        return self._diffuse_mass("Carbon")

    @_lazy
    def DiffuseOxygenMass(self):
        return self._diffuse_mass("Oxygen")

    @_lazy
    def DiffuseMagnesiumMass(self):
        return self._diffuse_mass("Magnesium")

    @_lazy
    def DiffuseSiliconMass(self):
        return self._diffuse_mass("Silicon")

    @_lazy
    def DiffuseIronMass(self):
        return self._diffuse_mass("Iron")

    # ---- cold dense gas ----

    @_lazy
    def _gas_cold_dense(self):
        """T < Tmax and n_H > n_min (reference
        ``cold_dense_gas_filter.py:57-77``), the density cut as a
        physical mass-density threshold applied to the snapshot's
        comoving densities (a^3)."""
        if not (self._has("PartType0/Temperatures") and self._has("PartType0/Densities")):
            return torch.zeros_like(self._gas_sel)
        rho_thresh_comoving = self.ctx.cold_dense_rho_threshold * self.ctx.a**3
        return (self._gas_temp < self.ctx.cold_dense_Tmax) & (
            self.field("PartType0/Densities") > rho_thresh_comoving
        )

    @_lazy
    def GasMassInColdDenseGas(self):
        return self._gas_sum(self._gas_mass, self._gas_cold_dense)

    @_lazy
    def GasMassInColdDenseDiffuseMetals(self):
        """Metal mass in cold dense gas, dust excluded."""
        if not (
            self._has("PartType0/MetalMassFractions")
            and self._has("PartType0/TotalDustMassFractions")
        ):
            return self._zeros()
        diffuse_z = self.field("PartType0/MetalMassFractions") - self.field(
            "PartType0/TotalDustMassFractions"
        )
        return self._gas_sum(self._gas_mass * diffuse_z, self._gas_cold_dense)

    # ---- dust grain species ----

    def _dust_sum(self, names):
        cols = [self._dust_col(n) for n in names]
        if any(c is None for c in cols):
            return None
        out = cols[0]
        for c in cols[1:]:
            out = out + c
        return out

    @_lazy
    def _graphite_frac(self):
        return self._dust_sum(("GraphiteLarge", "GraphiteSmall"))

    @_lazy
    def _silicates_frac(self):
        return self._dust_sum(
            ("MgSilicatesLarge", "FeSilicatesLarge", "MgSilicatesSmall", "FeSilicatesSmall")
        )

    @_lazy
    def _large_grain_frac(self):
        return self._dust_sum(("GraphiteLarge", "MgSilicatesLarge", "FeSilicatesLarge"))

    @_lazy
    def _small_grain_frac(self):
        return self._dust_sum(("GraphiteSmall", "MgSilicatesSmall", "FeSilicatesSmall"))

    def _dust_mass(self, frac, extra_mask=None):
        if frac is None:
            return self._zeros()
        return self._gas_sum(self._gas_mass * frac, extra_mask)

    def _dust_mass_in(self, frac, mask):
        """Dust mass in a gas phase; zero when the phase is undefined."""
        return self._zeros() if mask is None else self._dust_mass(frac, mask)

    @_lazy
    def DustGraphiteMass(self):
        return self._dust_mass(self._graphite_frac)

    @_lazy
    def DustSilicatesMass(self):
        return self._dust_mass(self._silicates_frac)

    @_lazy
    def DustLargeGrainMass(self):
        return self._dust_mass(self._large_grain_frac)

    @_lazy
    def DustSmallGrainMass(self):
        return self._dust_mass(self._small_grain_frac)

    @_lazy
    def _gas_atomic_mask(self):
        """Atomic gas: more HI than H2."""
        f, h2 = self._gas_HI_frac, self._gas_H2_frac
        return None if f is None or h2 is None else f > h2

    @_lazy
    def _gas_molecular_mask(self):
        f, h2 = self._gas_HI_frac, self._gas_H2_frac
        return None if f is None or h2 is None else h2 >= f

    @_lazy
    def _gas_sfr_mask(self):
        if not self._has("PartType0/StarFormationRates"):
            return None
        return self._gas_sfr > 0.0

    @_lazy
    def DustGraphiteMassInAtomicGas(self):
        return self._dust_mass_in(self._graphite_frac, self._gas_atomic_mask)

    @_lazy
    def DustSilicatesMassInAtomicGas(self):
        return self._dust_mass_in(self._silicates_frac, self._gas_atomic_mask)

    @_lazy
    def DustGraphiteMassInMolecularGas(self):
        return self._dust_mass_in(self._graphite_frac, self._gas_molecular_mask)

    @_lazy
    def DustSilicatesMassInMolecularGas(self):
        return self._dust_mass_in(self._silicates_frac, self._gas_molecular_mask)

    @_lazy
    def DustGraphiteMassInColdDenseGas(self):
        return self._dust_mass(self._graphite_frac, self._gas_cold_dense)

    @_lazy
    def DustSilicatesMassInColdDenseGas(self):
        return self._dust_mass(self._silicates_frac, self._gas_cold_dense)

    @_lazy
    def DustLargeGrainMassInColdDenseGas(self):
        return self._dust_mass(self._large_grain_frac, self._gas_cold_dense)

    @_lazy
    def DustSmallGrainMassInColdDenseGas(self):
        return self._dust_mass(self._small_grain_frac, self._gas_cold_dense)

    @_lazy
    def DustLargeGrainMassInMolecularGas(self):
        return self._dust_mass_in(self._large_grain_frac, self._gas_molecular_mask)

    @_lazy
    def DustSmallGrainMassInMolecularGas(self):
        return self._dust_mass_in(self._small_grain_frac, self._gas_molecular_mask)

    @_lazy
    def DustLargeGrainMassSFRWeighted(self):
        return self._dust_mass_in(self._large_grain_frac, self._gas_sfr_mask)

    @_lazy
    def DustSmallGrainMassSFRWeighted(self):
        return self._dust_mass_in(self._small_grain_frac, self._gas_sfr_mask)

    # ---- gas abundance ratios, over cold dense gas; the atomic mass
    # constants are the reference's (``aperture_properties.py:2660-3398``)

    @staticmethod
    def _ratio_OH(O, H):
        if O is None or H is None:
            return None
        return O / (16.0 * torch.clamp(H, min=1e-37))

    @staticmethod
    def _ratio_NO(N, O):
        if N is None or O is None:
            return None
        return torch.where(O != 0, (16.0 * N) / (14.0 * torch.clamp(O, min=1e-37)), 0.0)

    @staticmethod
    def _ratio_CO(C, O):
        if C is None or O is None:
            return None
        return torch.where(O != 0, (16.0 * C) / (12.011 * torch.clamp(O, min=1e-37)), 0.0)

    def _linear_mw_gas(self, ratio):
        if ratio is None:
            return self._zeros()
        num = self._gas_sum(self._gas_mass * ratio, self._gas_cold_dense)
        den = self.GasMassInColdDenseGas
        return torch.where(den > 0, num / torch.clamp(den, min=1e-37), 0.0)

    def _log_mw_gas(self, ratio, solar_const, floor_factor, extra_mask=None):
        """10^(mass-weighted mean of log10(ratio), the ratio floored at
        floor_factor x solar) over cold dense gas."""
        if ratio is None:
            return self._zeros()
        solar = self.ctx.constant(solar_const, 0.0)
        if solar <= 0:
            return self._zeros()
        logr = torch.log10(torch.clamp(ratio, min=solar * floor_factor))
        mask = self._gas_cold_dense
        if extra_mask is not None:
            mask = mask & extra_mask
        num = self._gas_sum(self._gas_mass * logr, mask)
        den = self._gas_sum(self._gas_mass, mask)
        return torch.where(den > 0, 10.0 ** (num / torch.clamp(den, min=1e-37)), 0.0)

    @_lazy
    def _gas_O_over_H_total(self):
        return self._ratio_OH(self._elem("PartType0", "Oxygen"), self._elem("PartType0", "Hydrogen"))

    @_lazy
    def _gas_O_over_H_diffuse(self):
        return self._ratio_OH(self._elem_diffuse("Oxygen"), self._elem("PartType0", "Hydrogen"))

    @_lazy
    def _gas_N_over_O_diffuse(self):
        return self._ratio_NO(self._elem_diffuse("Nitrogen"), self._elem_diffuse("Oxygen"))

    @_lazy
    def _gas_C_over_O_diffuse(self):
        return self._ratio_CO(self._elem_diffuse("Carbon"), self._elem_diffuse("Oxygen"))

    @_lazy
    def LinearMassWeightedOxygenOverHydrogenOfGas(self):
        return self._linear_mw_gas(self._gas_O_over_H_total)

    @_lazy
    def LinearMassWeightedDiffuseOxygenOverHydrogenOfGas(self):
        return self._linear_mw_gas(self._gas_O_over_H_diffuse)

    @_lazy
    def LinearMassWeightedNitrogenOverOxygenOfGas(self):
        return self._linear_mw_gas(
            self._ratio_NO(self._elem("PartType0", "Nitrogen"), self._elem("PartType0", "Oxygen"))
        )

    @_lazy
    def LinearMassWeightedDiffuseNitrogenOverOxygenOfGas(self):
        return self._linear_mw_gas(self._gas_N_over_O_diffuse)

    @_lazy
    def LinearMassWeightedCarbonOverOxygenOfGas(self):
        return self._linear_mw_gas(
            self._ratio_CO(self._elem("PartType0", "Carbon"), self._elem("PartType0", "Oxygen"))
        )

    @_lazy
    def LinearMassWeightedDiffuseCarbonOverOxygenOfGas(self):
        return self._linear_mw_gas(self._gas_C_over_O_diffuse)

    @_lazy
    def LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfGasLowLimit(self):
        return self._log_mw_gas(self._gas_O_over_H_diffuse, "O_H_sun", 1.0e-4)

    @_lazy
    def LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfGasHighLimit(self):
        return self._log_mw_gas(self._gas_O_over_H_diffuse, "O_H_sun", 1.0e-3)

    @_lazy
    def LogarithmicMassWeightedDiffuseNitrogenOverOxygenOfGasLowLimit(self):
        return self._log_mw_gas(self._gas_N_over_O_diffuse, "N_O_sun", 1.0e-4)

    @_lazy
    def LogarithmicMassWeightedDiffuseNitrogenOverOxygenOfGasHighLimit(self):
        return self._log_mw_gas(self._gas_N_over_O_diffuse, "N_O_sun", 1.0e-3)

    @_lazy
    def LogarithmicMassWeightedDiffuseCarbonOverOxygenOfGasLowLimit(self):
        return self._log_mw_gas(self._gas_C_over_O_diffuse, "C_O_sun", 1.0e-4)

    @_lazy
    def LogarithmicMassWeightedDiffuseCarbonOverOxygenOfGasHighLimit(self):
        return self._log_mw_gas(self._gas_C_over_O_diffuse, "C_O_sun", 1.0e-3)

    @_lazy
    def LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfAtomicGasLowLimit(self):
        return self._log_mw_gas(
            self._gas_O_over_H_diffuse, "O_H_sun", 1.0e-4, self._gas_atomic_mask
        )

    @_lazy
    def LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfAtomicGasHighLimit(self):
        return self._log_mw_gas(
            self._gas_O_over_H_diffuse, "O_H_sun", 1.0e-3, self._gas_atomic_mask
        )

    @_lazy
    def LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfMolecularGasLowLimit(self):
        return self._log_mw_gas(
            self._gas_O_over_H_diffuse, "O_H_sun", 1.0e-4, self._gas_molecular_mask
        )

    @_lazy
    def LogarithmicMassWeightedDiffuseOxygenOverHydrogenOfMolecularGasHighLimit(self):
        return self._log_mw_gas(
            self._gas_O_over_H_diffuse, "O_H_sun", 1.0e-3, self._gas_molecular_mask
        )

    # ---- stellar abundance ratios ----

    def _star_sum(self, values, extra_mask=None):
        if values is None:
            return self._zeros()
        mask = self._star_sel if extra_mask is None else self._star_sel & extra_mask
        return masked_sum(values, mask)

    def _per_star_mass(self, num):
        return torch.where(self.Mstar > 0, num / torch.clamp(self.Mstar, min=1e-37), 0.0)

    def _linear_mw_star(self, ratio):
        if ratio is None:
            return self._zeros()
        return self._per_star_mass(self._star_sum(self._star_mass * ratio))

    def _log_mw_star(self, ratio, solar_const, floor_factor):
        if ratio is None:
            return self._zeros()
        solar = self.ctx.constant(solar_const, 0.0)
        if solar <= 0:
            return self._zeros()
        logr = torch.log10(torch.clamp(ratio, min=solar * floor_factor))
        num = self._star_sum(self._star_mass * logr)
        return torch.where(
            self.Mstar > 0, 10.0 ** (num / torch.clamp(self.Mstar, min=1e-37)), 0.0
        )

    def _star_over_H(self, values, atomic_mass):
        h = self._elem("PartType4", "Hydrogen")
        if values is None or h is None:
            return None
        return values / (atomic_mass * torch.clamp(h, min=1e-37))

    @_lazy
    def _star_Fe_over_H(self):
        return self._star_over_H(self._elem("PartType4", "Iron"), 55.845)

    @_lazy
    def _star_Mg_over_H(self):
        return self._star_over_H(self._elem("PartType4", "Magnesium"), 24.305)

    @_lazy
    def _star_FeSNIa_over_H(self):
        if not self._has("PartType4/IronMassFractionsFromSNIa"):
            return None
        return self._star_over_H(self.field("PartType4/IronMassFractionsFromSNIa"), 55.845)

    @_lazy
    def LinearMassWeightedIronOverHydrogenOfStars(self):
        return self._linear_mw_star(self._star_Fe_over_H)

    @_lazy
    def LinearMassWeightedMagnesiumOverHydrogenOfStars(self):
        return self._linear_mw_star(self._star_Mg_over_H)

    @_lazy
    def LinearMassWeightedIronFromSNIaOverHydrogenOfStars(self):
        return self._linear_mw_star(self._star_FeSNIa_over_H)

    @_lazy
    def LogarithmicMassWeightedIronOverHydrogenOfStarsLowLimit(self):
        return self._log_mw_star(self._star_Fe_over_H, "Fe_H_sun", 1.0e-4)

    @_lazy
    def LogarithmicMassWeightedIronOverHydrogenOfStarsHighLimit(self):
        return self._log_mw_star(self._star_Fe_over_H, "Fe_H_sun", 1.0e-3)

    @_lazy
    def LogarithmicMassWeightedMagnesiumOverHydrogenOfStarsLowLimit(self):
        return self._log_mw_star(self._star_Mg_over_H, "Mg_H_sun", 1.0e-4)

    @_lazy
    def LogarithmicMassWeightedMagnesiumOverHydrogenOfStarsHighLimit(self):
        return self._log_mw_star(self._star_Mg_over_H, "Mg_H_sun", 1.0e-3)

    @_lazy
    def LogarithmicMassWeightedIronFromSNIaOverHydrogenOfStarsLowLimit(self):
        return self._log_mw_star(self._star_FeSNIa_over_H, "Fe_H_sun", 1.0e-4)

    # ---- gas element mass fractions ----

    def _gas_elem_frac(self, element, sf_only=False):
        e = self._elem("PartType0", element)
        mask = self._gas_sfr_mask if sf_only else None
        if e is None or (sf_only and mask is None):
            return self._zeros()
        num = self._gas_sum(self._gas_mass * e, mask)
        den = self.Mgas_SF if sf_only else self.Mgas
        return torch.where(den > 0, num / torch.clamp(den, min=1e-37), 0.0)

    @_lazy
    def gasOfrac(self):
        return self._gas_elem_frac("Oxygen")

    @_lazy
    def gasFefrac(self):
        return self._gas_elem_frac("Iron")

    @_lazy
    def gasOfrac_SF(self):
        return self._gas_elem_frac("Oxygen", sf_only=True)

    @_lazy
    def gasFefrac_SF(self):
        return self._gas_elem_frac("Iron", sf_only=True)

    # ---- supernova rates ----

    @_lazy
    def TotalSNIaRate(self):
        if not self._has("PartType4/SNIaRates"):
            return self._zeros()
        return self._star_sum(self.field("PartType4/SNIaRates"))

    # ---- star element mass fractions ----

    def _star_elem_frac(self, element):
        e = self._elem("PartType4", element)
        return self._per_star_mass(self._star_sum(None if e is None else self._star_mass * e))

    @_lazy
    def starOfrac(self):
        return self._star_elem_frac("Oxygen")

    @_lazy
    def starMgfrac(self):
        return self._star_elem_frac("Magnesium")

    @_lazy
    def starFefrac(self):
        return self._star_elem_frac("Iron")

    # ---- HI / H2 shell flow rates (SO) ----

    def _species_flow(self, frac):
        if frac is None or not getattr(self, "virial_definition", False):
            return self._zeros(6)
        return self._flow_rate(
            self._valid_type_mask("PartType0"), self._full_from_gas(self._gas_mass * frac), "mass"
        )

    @_lazy
    def HIMassFlowRate(self):
        return self._species_flow(self._gas_HI_frac)

    @_lazy
    def H2MassFlowRate(self):
        return self._species_flow(self._gas_H2_frac)
