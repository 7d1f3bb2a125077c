"""Parameter files: sections, templated paths and per-property queries.

The port's copy of ``soap_tpu/core/params.py`` (reference
``SOAP/core/parameter_file.py`` and ``SOAP/core/combine_args.py``): a
file with sections ``Parameters / Snapshots / HaloFinder /
GroupMembership / ExtraInput / HaloProperties / <halo types> / aliases /
filters / defined_constants / calculations``, ``{param}`` path templating
with ``{snap_nr}`` / ``{file_nr}`` deferred, per-property filter
selection, halo-type variations, aliases and defined constants.

A ``.json`` path is read with ``json``; any other path is YAML, and
``yaml`` is imported only then, so a run driven by a dict or by the
package's JSON copies needs no yaml.  The five production files ship as
JSON (``parameter_file_path``): each is what ``yaml.safe_load`` returns
for ``parameter_files/<name>.yml``, quirks included (YAML 1.1 reads
exponents without a dot, such as ``3.16e4``, as strings).  The
``.used_parameters`` mirror (``write_parameters``) imports yaml when
it writes.
"""

from __future__ import annotations

import json
import string
from importlib import resources
from typing import Dict, List, Optional, Tuple

#: the production parameter files shipped as JSON
PARAMETER_FILES = (
    "COLIBRE_HYBRID", "COLIBRE_THERMAL", "EAGLE", "FLAMINGO", "MINIMAL_FLAMINGO",
)


def parameter_file_path(name: str) -> str:
    """Path of a shipped parameter file's JSON copy, by its name
    (``"FLAMINGO"``, with or without ``.yml`` / ``.json``)."""
    base = name.rsplit("/", 1)[-1]
    for ext in (".yml", ".json"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    if base not in PARAMETER_FILES:
        raise KeyError(f"no shipped parameter file {name!r}; have {PARAMETER_FILES}")
    return str(resources.files("soap_tpu_torch.core").joinpath(
        "parameter_files", f"{base}.json"))


class _KeepMissingFormatter(string.Formatter):
    """Substitute known fields, keep unknown or None fields as ``{name}``,
    so that ``{snap_nr}`` and ``{file_nr}`` survive the first pass."""

    def get_value(self, key, args, kwargs):
        if isinstance(key, str):
            val = kwargs.get(key, None)
            if val is None:
                return "{" + key + "}"
            return val
        return super().get_value(key, args, kwargs)

    def format_field(self, value, format_spec):
        if isinstance(value, str) and value.startswith("{") and value.endswith("}"):
            # a kept-back placeholder: re-attach its format spec
            if format_spec:
                return value[:-1] + ":" + format_spec + "}"
            return value
        return super().format_field(value, format_spec)


def substitute_parameters(config: Dict, overrides: Dict) -> Dict:
    """Merge command-line overrides into the Parameters section and
    template the other sections' strings with its values (plus
    ``halo_finder`` from ``HaloFinder/type``); ``{snap_nr}`` and
    ``{file_nr}`` stay unexpanded."""
    out: Dict = {"Parameters": dict(config.get("Parameters", {}))}
    for name, value in overrides.items():
        name = name.replace("-", "_")
        if value is not None or name not in out["Parameters"]:
            out["Parameters"][name] = value

    fmt = _KeepMissingFormatter()
    values = {
        k: v for k, v in out["Parameters"].items() if k not in ("snap_nr", "file_nr")
    }
    values["snap_nr"] = None
    values["file_nr"] = None
    if "HaloFinder" in config:
        values.setdefault("halo_finder", config["HaloFinder"].get("type"))

    def subst(node):
        if isinstance(node, str):
            return fmt.vformat(node, (), values)
        if isinstance(node, dict):
            return {k: subst(v) for k, v in node.items()}
        if isinstance(node, list):
            return [subst(v) for v in node]
        return node

    for section, content in config.items():
        if section == "Parameters":
            continue
        out[section] = subst(content)
    return out


class ParameterFile:
    """The parameter dictionary with SOAP's queries."""

    HALO_TYPE_SECTIONS = (
        "SubhaloProperties",
        "ApertureProperties",
        "ProjectedApertureProperties",
        "SOProperties",
    )

    def __init__(
        self,
        file_name: Optional[str] = None,
        parameter_dictionary: Optional[Dict] = None,
        snipshot: bool = False,
    ):
        if file_name is not None:
            with open(file_name) as f:
                if str(file_name).endswith(".json"):
                    self.parameters: Dict = json.load(f)
                else:
                    import yaml

                    self.parameters = yaml.safe_load(f)
        else:
            self.parameters = dict(parameter_dictionary or {})
        self.snipshot = snipshot
        self._aliases: Optional[Dict[str, str]] = None
        self.unregistered: set = set()
        #: the filter chosen per property, per halo type
        self.property_filters: Dict[str, Dict[str, object]] = {}

    # ---- top-level knobs ----
    def calculate_missing_properties(self) -> bool:
        return self.parameters.get("calculations", {}).get(
            "calculate_missing_properties", True
        )

    def strict_halo_copy(self) -> bool:
        return self.parameters.get("calculations", {}).get("strict_halo_copy", False)

    def recently_heated_gas_params(self) -> Dict:
        return dict(
            self.parameters.get("calculations", {}).get("recently_heated_gas_filter", {})
        )

    def get_parameters(self) -> Dict:
        return dict(self.parameters)

    def write_parameters(self, file_name: str = "SOAP.used_parameters.yml") -> None:
        """The parameters as YAML (the ``.used_parameters`` mirror), with
        the entries ``get_property_filters`` filled in."""
        import yaml

        with open(file_name, "w") as f:
            yaml.safe_dump(self.parameters, f)

    # ---- property selection ----
    def get_property_filters(
        self, base_halo_type: str, full_list: List[str]
    ) -> Dict[str, object]:
        """Filter name per property, or False when disabled: a listed
        value is a filter name, ``True`` ("basic"), ``False`` or a
        ``{snapshot:, snipshot:}`` dict; unlisted properties are "basic"
        with ``calculate_missing_properties``, else False."""
        section = self.parameters.setdefault(base_halo_type, {})
        listed = section.setdefault("properties", {})
        filters: Dict[str, object] = {}
        for prop in full_list:
            if prop in listed:
                value = listed[prop]
                if isinstance(value, dict):
                    value = value["snipshot" if self.snipshot else "snapshot"]
                if value is True:
                    value = "basic"
                filters[prop] = value
            elif self.calculate_missing_properties():
                filters[prop] = "basic"
                listed[prop] = "basic"
                self.unregistered.add((base_halo_type, prop))
            else:
                filters[prop] = False
            chosen = filters[prop]
            if isinstance(chosen, str):
                defined = chosen in self.parameters.get("filters", {})
                if not (defined or chosen == "basic"):
                    raise ValueError(f'Filter "{chosen}" is not defined in parameter file')
            elif chosen is not False:
                raise ValueError(
                    f"Invalid filter value {chosen!r} for {base_halo_type}/{prop}"
                )
        self.property_filters.setdefault(base_halo_type, {}).update(filters)
        return filters

    def get_halo_type_variations(self, base_halo_type: str, default_variations: Dict) -> Dict:
        """Variation dicts (aperture radii, SO definitions ...) per type;
        the defaults are recorded in the parameters when none are given."""
        section = self.parameters.setdefault(base_halo_type, {})
        if "variations" not in section:
            section["variations"] = {
                name: dict(cfg) for name, cfg in default_variations.items()
            }
        return dict(section["variations"])

    # ---- dataset aliasing ----
    def get_aliases(self) -> Dict[str, str]:
        if self._aliases is None:
            aliases = dict(self.parameters.get("aliases", {}) or {})
            if "snipshot" in aliases:
                snip = aliases.pop("snipshot")
                if self.snipshot:
                    aliases = dict(snip)
            self._aliases = aliases
        return self._aliases

    def get_particle_property(self, property_name: str) -> Tuple[str, str]:
        property_name = self.get_aliases().get(property_name, property_name)
        parts = property_name.split("/")
        if len(parts) != 2:
            raise RuntimeError(f'Unable to parse particle property name "{property_name}"!')
        return parts[0], parts[1]

    # ---- category filters & constants ----
    def get_filters(self, default_filters: Dict) -> Dict:
        filters = dict(default_filters)
        section = self.parameters.setdefault("filters", {})
        for category in default_filters:
            if category in section:
                filters[category] = section[category]
            else:
                section[category] = filters[category]
        return filters

    def get_defined_constants(self) -> Dict:
        return dict(self.parameters.get("defined_constants", {}) or {})
