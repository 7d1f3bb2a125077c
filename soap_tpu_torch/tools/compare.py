"""Catalogue comparison tool.

The port's copy of ``soap_tpu/tools/compare.py`` (reference
``misc/compare_new_implementation.py:5-40``): a per-dataset diff between
two catalogues, exact or at each lossy compression filter's tolerance.
h5py is imported inside ``compare_catalogues``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from soap_tpu_torch.tools.compression import lossy_filter_name, open_relaxed

#: relative tolerance implied by each SWIFT lossy compression filter
#: (mantissa bits -> 2^-bits; DScale = absolute decimal scaling)
FILTER_RTOL = {
    "None": 0.0,
    "FMantissa9": 2.0**-9,
    "FMantissa13": 2.0**-13,
    "DMantissa9": 2.0**-9,
    "DScale1": 0.0,  # absolute 0.1 handled via atol
    "DScale5": 0.0,
    "DScale6": 0.0,
    "Nbit40": 2.0**-30,
}
FILTER_ATOL = {"DScale1": 0.1, "DScale5": 1.0e-5, "DScale6": 1.0e-6}


@dataclass
class Difference:
    name: str
    kind: str  # 'missing', 'shape', 'dtype', 'values'
    detail: str


@dataclass
class ComparisonResult:
    n_compared: int = 0
    differences: List[Difference] = field(default_factory=list)

    @property
    def identical(self) -> bool:
        return not self.differences

    def report(self) -> str:
        if self.identical:
            return f"{self.n_compared} datasets compared, no differences"
        lines = [f"{self.n_compared} datasets compared, {len(self.differences)} differ:"]
        for d in self.differences:
            lines.append(f"  [{d.kind}] {d.name}: {d.detail}")
        return "\n".join(lines)


def compare_catalogues(
    path_a: str,
    path_b: str,
    use_compression_tolerance: bool = True,
    rtol: float = 0.0,
    atol: float = 0.0,
    scale_atol: float = 0.0,
) -> ComparisonResult:
    """Compare every dataset of two catalogue files.

    ``scale_atol`` adds a per-dataset absolute tolerance of
    ``scale_atol * max|A|``: components orders of magnitude below their
    dataset's scale (near-zero inertia off-diagonals) carry no
    information at that precision, but an element-wise rtol alone flags
    them when a boundary particle moves by one f32 ulp of the selection
    radius.
    """
    import h5py

    result = ComparisonResult()
    with open_relaxed(path_a) as fa, open_relaxed(path_b) as fb:
        names_a: List[str] = []
        fa.visit(lambda n: names_a.append(n)
                 if fa.get(n, getclass=True) is h5py.Dataset else None)
        names_b: List[str] = []
        fb.visit(lambda n: names_b.append(n)
                 if fb.get(n, getclass=True) is h5py.Dataset else None)
        for name in sorted(set(names_a) | set(names_b)):
            if name not in names_a or name not in names_b:
                result.differences.append(Difference(
                    name, "missing", "only in " + ("B" if name not in names_a else "A")))
                continue
            da, db = fa[name], fb[name]
            result.n_compared += 1
            if da.shape != db.shape:
                result.differences.append(Difference(name, "shape", f"{da.shape} vs {db.shape}"))
                continue
            a, b = da[...], db[...]
            r, t = rtol, atol
            if use_compression_tolerance:
                filt = lossy_filter_name(da.attrs)
                r = max(r, FILTER_RTOL.get(filt, 0.0))
                t = max(t, FILTER_ATOL.get(filt, 0.0))
            if a.dtype.kind in "fc":
                if scale_atol > 0.0 and a.size:
                    scale = float(np.nanmax(np.abs(a.astype(np.float64))))
                    if np.isfinite(scale):
                        t = max(t, scale_atol * scale)
                ok = np.allclose(a, b, rtol=r, atol=t, equal_nan=True)
            else:
                ok = np.array_equal(a, b)
            if not ok:
                with np.errstate(divide="ignore", invalid="ignore"):
                    denom = np.maximum(np.abs(a).astype(np.float64), 1e-37)
                    relerr = np.abs(a.astype(np.float64) - b.astype(np.float64)) / denom
                result.differences.append(Difference(
                    name, "values",
                    f"max rel err {np.nanmax(relerr):.3e} (tol rtol={r:.1e} atol={t:.1e})"))
    return result
