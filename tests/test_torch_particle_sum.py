"""Particle sums: ``ops/reductions.py::particle_sum`` and kernel K3
(``csrc/particle_sum.cu``).

On the CPU the sums keep the plain expressions bit for bit (a
``Summand``'s mask and ``out_dtype`` and the centre-of-mass helpers
against the expressions they replace), launch nothing, and the wrapper's
layout is checked against a numpy model of the kernel's order of
additions.  The
``card`` tests need a CUDA card and skip without one; run them there
from the repository's root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_particle_sum.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package's mock
writer, which needs h5py).
"""

import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from soap_tpu_torch.ops import reductions as red

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _lognormal(rng, *shape):
    return torch.from_numpy(rng.lognormal(0.0, 1.0, shape).astype(np.float32))


def _signed(rng, *shape):
    return torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32))


# ------------------------------------------------ the expressions replaced


def old_particle_sum(x, dim=1):
    if not x.dtype.is_floating_point:
        return x.sum(dim)
    return x.sum(dim, dtype=torch.float64).to(x.dtype)


def old_masked_sum(x, mask):
    if x.dim() > mask.dim():
        mask = mask[..., None]
    return old_particle_sum(torch.where(mask, x, 0))


def old_centre_of_mass(mass, pos, mask):
    m = torch.where(mask, mass, 0.0)
    mtot = old_particle_sum(m)
    com = old_particle_sum(m[..., None] * pos) / torch.clamp(mtot[..., None], min=1e-37)
    return mtot, torch.where(mtot[:, None] > 0, com, 0.0)


def old_velocity_dispersion_matrix(mass, vel, vcom, mask):
    m = torch.where(mask, mass, 0.0)
    frac = m / torch.clamp(old_particle_sum(m), min=1e-37)[:, None]
    dv = torch.where(mask[..., None], vel - vcom[:, None, :], 0.0)
    x, y, z = dv[..., 0], dv[..., 1], dv[..., 2]
    return torch.stack([old_particle_sum(frac * a * b)
                        for a, b in ((x, x), (y, y), (z, z), (x, y), (x, z), (y, z))], 1)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = _signed(rng, *shape)
    mask = torch.from_numpy(rng.random(shape[:2]) < 0.7)
    mask[0] = False  # an empty selection
    return x, mask


#: (B, K), (B, K, D) over the particle axis and (B, C, k) over the last
SHAPES = [((5, 200), 1), ((5, 200, 3), 1), ((4, 6, 133), -1), ((3, 9000), 1)]


@pytest.mark.parametrize("shape,dim", SHAPES)
@pytest.mark.parametrize("seed", [1, 2])
def test_cpu_sums_keep_the_plain_expressions(shape, dim, seed):
    """``particle_sum`` with and without a mask or ``out_dtype`` equals
    the expressions it replaces bit for bit, on contiguous and strided
    views, and launches nothing."""
    x, mask = _inputs(seed, shape)
    n0 = (red.launches, red.launches_here())
    assert torch.equal(red.particle_sum(x, dim), old_particle_sum(x, dim))
    assert torch.equal(red.particle_sum(red.Summand(x, out_dtype=torch.float64), dim),
                       old_particle_sum(x.to(torch.float64), dim))
    if dim == 1:
        assert torch.equal(red.masked_sum(x, mask), old_masked_sum(x, mask))
        assert torch.equal(red.particle_sum(red.Summand(x, mask)), old_masked_sum(x, mask))
        m = mask if x.dim() == 2 else mask[..., None]
        assert torch.equal(
            red.particle_sum(red.Summand(x, mask, torch.float64)),
            old_particle_sum(torch.where(m, x, 0.0).to(torch.float64)),
        )
    # strided views: every other row of the reduced axis, a column
    view = x[:, ::2] if dim == 1 else x[..., ::3]
    assert not view.is_contiguous()
    assert torch.equal(red.particle_sum(view, dim), old_particle_sum(view, dim))
    if x.dim() == 3 and dim == 1:
        col = x[..., 1]
        assert torch.equal(red.masked_sum(col, mask), old_masked_sum(col, mask))
    assert (red.launches, red.launches_here()) == n0


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_cpu_centre_of_mass_and_dispersion_keep_the_plain_expressions(seed):
    rng = np.random.default_rng(seed)
    B, K = 6, 300
    mass = _lognormal(rng, B, K)
    pos, vel = _signed(rng, B, K, 3), 100.0 * _signed(rng, B, K, 3)
    mask = torch.from_numpy(rng.random((B, K)) < 0.6)
    mask[1] = False
    got, want = red.centre_of_mass(mass, pos, mask), old_centre_of_mass(mass, pos, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the centre-of-mass velocity is the same expression over velocities
    vcom = old_centre_of_mass(mass, vel, mask)[1]
    assert torch.equal(red.centre_of_mass_velocity(mass, vel, mask), vcom)
    assert torch.equal(red.velocity_dispersion_matrix(mass, vel, vcom, mask),
                       old_velocity_dispersion_matrix(mass, vel, vcom, mask))


def test_integer_sums_stay_integer():
    x = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    mask = x % 3 == 0
    assert torch.equal(red.particle_sum(x), x.sum(1))
    assert torch.equal(red.particle_sum(red.Summand(x, mask)), torch.where(mask, x, 0).sum(1))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.float16, torch.int64])
def test_sums_round_to_nothing_below_float64(out_dtype):
    """A ``Summand``'s ``out_dtype`` is None or float64: a sum rounds once,
    to its input's dtype or to float64, never to another."""
    x = torch.ones(2, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="out_dtype"):
        red.particle_sum(red.Summand(x, out_dtype=out_dtype))


@pytest.mark.parametrize("case", ["float16", "bfloat16", "0-d", "four row axes"])
def test_the_kernel_refuses_what_it_cannot_read(case):
    """A layout K3 does not take raises where its launch is planned (on
    the card ``particle_sum`` has no other path)."""
    x, dim = {
        "float16": (torch.ones(3, 40, dtype=torch.float16), 1),
        "bfloat16": (torch.ones(3, 40, dtype=torch.bfloat16), 1),
        "0-d": (torch.tensor(1.0), 0),
        # every other element of each axis: no two axes merge
        "four row axes": (torch.ones(4, 6, 8, 10, 12)[::2, ::2, ::2, ::2, ::2], 2),
    }[case]
    with pytest.raises(ValueError, match="particle_sum: K3"):
        red._plan(x, dim, None, x.dtype)


@pytest.mark.parametrize("shape,dim,want", [
    ((8, 100), 1, [(8, [100])]),
    ((8, 100, 3), 1, [(8, [300]), (3, [1])]),
    ((8, 6, 40), 2, [(48, [40])]),
    ((8, 1, 40), 2, [(8, [40])]),
    ((2, 3, 5, 7), 2, [(6, [35]), (7, [1])]),
])
def test_row_axes_merge_what_steps_as_one(shape, dim, want):
    strides = torch.empty(shape).stride()
    assert red.row_axes(shape, [strides], dim) == want


def test_row_axes_keep_apart_what_a_mask_steps_differently():
    x = torch.empty(4, 50, 3)
    mask = torch.empty(4, 50, 1, dtype=torch.bool).expand(4, 50, 3)
    assert red.row_axes(x.shape, [x.stride(), mask.stride()], 1) == [
        (4, [150, 50]), (3, [1, 0])]


@pytest.mark.parametrize("items,n_sm,want", [
    (10**6, 132, 8), (2112, 132, 8), (2104, 132, 4), (256, 132, 1), (1, 132, 1),
])
def test_warps_per_block_spread_few_rows(items, n_sm, want):
    assert red.warps_per_block(items, n_sm) == want


# --------------------------------------- a numpy model of the kernel's order


def kernel_order_sum(x, mask, out_dtype):
    """The kernel's sums of (rows, K) host tensors, in its order of
    additions: per chunk of CHUNK elements, lane l adds quads l, l + 32,
    ... element by element; the lanes by an xor butterfly; a row's
    chunks in order."""
    x = x.to(torch.float64)
    if mask is not None:
        x = torch.where(mask, x, 0.0)
    rows, K = x.shape
    n_chunks = max(1, -(-K // red.CHUNK))
    v = np.zeros((rows, n_chunks * red.CHUNK))
    v[:, :K] = x.numpy()
    v = v.reshape(rows, n_chunks, red.CHUNK // 128, 32, 4)
    acc = np.zeros(v.shape[:2] + (32,))
    for step in range(v.shape[2]):
        for e in range(4):
            acc = acc + v[:, :, step, :, e]
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    total = acc[:, 0, 0]
    for c in range(1, n_chunks):
        total = total + acc[:, c, 0]
    return torch.from_numpy(total).to(out_dtype)


def _emulated_entry(g, x, mask, out, partial, stream):
    """K3's C entry point on host memory: reads the elements at the
    addresses the kernel would, from the launch ``g``, in the kernel's
    order."""
    tin = ctypes.c_double if g.in_f64 else ctypes.c_float
    tout = ctypes.c_double if g.out_f64 else ctypes.c_float
    r = np.arange(g.n_rows)
    r0, r1, r2 = r // (g.n1 * g.n2), (r // g.n2) % g.n1, r % g.n2
    k = np.arange(g.K)
    idx = (r0 * g.xs0 + r1 * g.xs1 + r2 * g.xs2)[:, None] + k[None, :] * g.xk
    buf = np.ctypeslib.as_array((tin * (int(idx.max()) + 1)).from_address(x))
    vals = torch.from_numpy(buf[idx].astype(np.float64))
    sel = None
    if mask:
        midx = (r0 * g.ms0 + r1 * g.ms1 + r2 * g.ms2)[:, None] + k[None, :] * g.mk
        mbuf = np.ctypeslib.as_array((ctypes.c_uint8 * (int(midx.max()) + 1)).from_address(mask))
        sel = torch.from_numpy(mbuf[midx].astype(bool))
    assert g.chunk == red.CHUNK and g.n_chunks == max(1, -(-g.K // g.chunk))
    assert (partial is not None) == (g.n_chunks > 1)
    got = kernel_order_sum(vals, sel, torch.float64 if g.out_f64 else torch.float32)
    np.ctypeslib.as_array((tout * g.n_rows).from_address(out))[:] = got.numpy()
    return 0


def test_launch_struct_matches_the_kernel_source():
    """``reductions.Launch`` has ``struct Launch``'s fields, in the
    order and of the C types that ``csrc/particle_sum.cu`` declares."""
    src = (ROOT / "soap_tpu_torch" / "csrc" / "particle_sum.cu").read_text()
    body = src[src.index("struct Launch {") + len("struct Launch {"):]
    body = re.sub(r"//[^\n]*", "", body[: body.index("};")])
    fields = []
    for decl in filter(str.strip, body.split(";")):
        ctype, names = re.fullmatch(r"\s*(int|long long)\s+(.*?)\s*", decl, re.S).groups()
        fields += [(n.strip(), {"int": ctypes.c_int, "long long": ctypes.c_longlong}[ctype])
                   for n in names.split(",")]
    assert [(n, t) for n, t in red.Launch._fields_] == fields


CASES = {
    "BK": lambda rng: (_signed(rng, 3, 300), 1, True, None),
    "BKD masked": lambda rng: (_signed(rng, 3, 300, 3), 1, True, None),
    "BCk f64 out": lambda rng: (_signed(rng, 3, 4, 37), -1, False, torch.float64),
    "column view": lambda rng: (_signed(rng, 3, 300, 3)[..., 0], 1, True, None),
    "f64 in": lambda rng: (_signed(rng, 3, 300).double(), 1, True, None),
    "f64 in f64 out": lambda rng: (_signed(rng, 3, 300).double(), 1, False, torch.float64),
    "split rows": lambda rng: (_lognormal(rng, 2, 2 * red.CHUNK + 37), 1, True, None),
    "transposed": lambda rng: (_signed(rng, 300, 3).t(), 1, False, None),
    "dim 0": lambda rng: (_signed(rng, 300, 3), 0, False, None),
    "K=1": lambda rng: (_signed(rng, 5, 1), 1, True, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_hands_the_kernel_its_layout(monkeypatch, case):
    """The wrapper's rows, strides, mask and dtypes, read by a model of
    the kernel's C entry point on host memory, give the plain sums: the
    same float32 values, float64 within the rounding of another order."""
    rng = np.random.default_rng(sorted(CASES).index(case))
    x, dim, masked, out_dtype = CASES[case](rng)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.random(x.shape[:2]) < 0.6)
        mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    monkeypatch.setattr(red, "_fn", _emulated_entry)
    monkeypatch.setitem(red._sm_counts, -1, 132)
    monkeypatch.setattr(red, "_raw_stream", lambda device: 0)
    n0 = red.launches_here()
    got = red._kernel_sum(x, dim, mask, out_dtype or x.dtype)
    assert red.launches_here() == n0 + 1
    want = red.particle_sum(red.Summand(x, mask, out_dtype), dim)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        xm = x if mask is None else torch.where(mask, x, 0)
        tol = x.shape[dim] * 2.0**-52 * xm.abs().double().sum(dim)
        assert ((got - want).abs() <= tol).all()


def test_padding_zeros_leaves_the_model_unchanged():
    """Zeros padded onto a row (a larger bucket capacity), through more
    chunks, leave the kernel order's float64 sums bit for bit."""
    x = _lognormal(np.random.default_rng(7), 4, 5000).double()
    wide = torch.nn.functional.pad(x, (0, 3 * 5000 + 128))
    assert torch.equal(kernel_order_sum(x, None, torch.float64),
                       kernel_order_sum(wide, None, torch.float64))


def test_engine_pass_launches_nothing_on_the_cpu():
    """An engine pass on the CPU counts no K3 sum."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from soap_tpu_torch.pipeline.engine import HaloEngine
    from soap_tpu_torch.utils.mock_data import build_mock_universe

    uni = build_mock_universe(n_halos=6, n_field=3000, boxsize=20.0, seed=11)
    ctx, chunk, args, specs = cs._bench_inputs(uni, torch.device("cpu"))
    specs = [s for s in specs if s.group in ("BoundSubhalo", "SO/200_crit")]
    n0 = red.launches
    eng = HaloEngine(ctx, chunk, specs, "cpu")
    eng.process(**args)
    assert red.launches == n0
    assert eng.stats.k3_launches_by_group == {}


# ------------------------------------------------------------- on the card


def float64_ties(got, x64_sum, bound):
    """Elements where ``got`` (float32) is one ulp from the float32
    rounding of ``x64_sum`` and the midpoint between the two lies within
    ``bound`` of ``x64_sum``: another order of float64 additions may
    round either way there."""
    want = x64_sum.float()
    diff = got != want
    mid = (got.double() + want.double()) / 2
    tie = diff & (torch.nextafter(want, got) == got) & ((mid - x64_sum).abs() <= bound)
    return diff, tie


def _check_against_float64(x, dim=1, mask=None):
    """K3 against ``x.double().sum(dim)``: float32 equal but at float64
    rounding ties (counted, one ulp at most); returns the tie count."""
    got = red.particle_sum(red.Summand(x, mask), dim)
    xm = x if mask is None else torch.where(mask, x, 0)
    s64 = xm.double().sum(dim)
    # two orders of K float64 additions differ by at most 2 K u sum|x|
    bound = 2 * x.shape[dim] * 2.0**-53 * xm.abs().double().sum(dim)
    diff, tie = float64_ties(got, s64, bound)
    assert torch.equal(diff, tie), f"{int((diff & ~tie).sum())} elements off beyond a tie"
    return int(tie.sum())


@pytest.mark.card
@pytest.mark.parametrize("shape,dim", [((1024, 8192), 1), ((256, 4100, 3), 1),
                                       ((64, 8, 33000), -1), ((3, 1 << 18), 1)])
def test_card_float32_equals_the_float64_path(card, shape, dim):
    rng = np.random.default_rng(list(shape))
    x = torch.from_numpy(rng.lognormal(0.0, 2.0, shape).astype(np.float32)).cuda()
    # over the particle axis, one mask for every column; over the last,
    # one for every (halo, config)
    mshape = shape[:2] + (1,) * (len(shape) - 2) if dim == 1 else shape
    mask = torch.from_numpy(rng.random(mshape) < 0.7).cuda()
    n0 = red.launches_here()
    ties = _check_against_float64(x, dim) + _check_against_float64(x, dim, mask)
    signed = x * (torch.rand_like(x) < 0.5).float().mul(2).sub(1)
    ties += _check_against_float64(signed, dim)
    assert red.launches_here() == n0 + 3
    print(f"{shape}: {ties} float64 rounding ties")
    f64 = red.particle_sum(red.Summand(x, out_dtype=torch.float64), dim)
    s64 = x.double().sum(dim)
    # float64 out: another order of K additions, within 2 K u sum|x|
    assert ((f64 - s64).abs() <= 2 * x.shape[dim] * 2.0**-53 * x.double().abs().sum(dim)).all()


@pytest.mark.card
@pytest.mark.parametrize("K", [1, 1000, 8192, 20000])
def test_card_capacity_independence(card, K):
    """A row padded with zeros to 4 K sums the same, bit for bit, in
    float32 and float64 out, masked or not."""
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.lognormal(0.0, 2.0, (37, K)).astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.random((37, K)) < 0.5).cuda()
    wide = torch.nn.functional.pad(x, (0, 3 * K))
    wmask = torch.nn.functional.pad(mask, (0, 3 * K))
    for od in (None, torch.float64):
        assert torch.equal(red.particle_sum(red.Summand(x, out_dtype=od)),
                           red.particle_sum(red.Summand(wide, out_dtype=od)))
        assert torch.equal(red.particle_sum(red.Summand(x, mask, od)),
                           red.particle_sum(red.Summand(wide, wmask, od)))


@pytest.mark.card
def test_card_split_rows_repeat_bit_for_bit(card):
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 1 << 20)).astype(
        np.float32)).cuda()
    runs = [red.particle_sum(red.Summand(x, out_dtype=torch.float64)) for _ in range(5)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert torch.equal(red.particle_sum(x), red.particle_sum(x))
    _check_against_float64(x)


@pytest.mark.card
def test_card_edges(card):
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 1)).astype(np.float32)).cuda()
    assert torch.equal(red.particle_sum(x), x[:, 0])
    empty = torch.zeros((0, 7), device="cuda")
    assert red.particle_sum(empty).shape == (0,)
    assert torch.equal(red.particle_sum(torch.zeros((4, 0), device="cuda")),
                       torch.zeros(4, device="cuda"))


@pytest.mark.card
def test_card_strided_inputs_match_their_contiguous_copies(card):
    """Non-contiguous inputs are read in place and sum as their
    contiguous copies do (same rows, same order)."""
    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.normal(size=(64, 5000, 3)).astype(np.float32)).cuda()
    mask = torch.from_numpy(rng.random((64, 5000)) < 0.5).cuda()
    for view, dim in ((base[..., 0], 1), (base[:, 1:], 1), (base.transpose(1, 2), -1),
                      (base[:, :, :2], 1)):
        assert torch.equal(red.particle_sum(view, dim), red.particle_sum(view.contiguous(), dim))
        _check_against_float64(view, dim)
    assert torch.equal(red.masked_sum(base[..., 2], mask),
                       red.masked_sum(base[..., 2].contiguous(), mask))
    assert torch.equal(red.masked_sum(base, mask), red.particle_sum(torch.where(
        mask[..., None], base, 0.0)))


@pytest.mark.card
@pytest.mark.parametrize("out_dtype", [torch.float64, None])
def test_card_float64_inputs(card, out_dtype):
    """Float64 inputs, contiguous and strided, masked or not, against
    PyTorch's float64 sum: within 2 K u sum|x| (another order of K
    float64 additions), in float64 whether or not ``out_dtype`` says so."""
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.normal(size=(40, 3000, 3))).cuda()
    mask = torch.from_numpy(rng.random((40, 3000)) < 0.5).cuda()
    for view, m in ((base, None), (base, mask), (base[..., 1], mask), (base[:, 1:, 0], None)):
        got = red.particle_sum(red.Summand(view, m, out_dtype), 1)
        xm = view if m is None else torch.where(red._trailing(m[:, : view.shape[1]], view.dim()),
                                                view, 0.0)
        s64 = xm.sum(1)
        tol = 2 * view.shape[1] * 2.0**-53 * xm.abs().sum(1)
        assert got.dtype == torch.float64
        assert ((got - s64).abs() <= tol).all()


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_card_refuses_what_the_kernel_cannot_read(card, dtype):
    """On the card a float sum K3 cannot read raises: there is no other
    path."""
    n0 = red.launches_here()
    with pytest.raises(ValueError, match="particle_sum: K3"):
        red.particle_sum(torch.ones(3, 40, dtype=dtype, device="cuda"))
    assert red.launches_here() == n0


@pytest.mark.card
def test_card_engine_pass_runs_every_float_sum_through_the_kernel(card):
    """One engine pass over a small universe with the full DMO list:
    every float particle sum launches K3, each counted under its
    family."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from soap_tpu_torch.pipeline.engine import HaloEngine
    from soap_tpu_torch.utils.mock_data import build_mock_universe

    uni = build_mock_universe(n_halos=24, n_field=20000, boxsize=30.0, seed=11)
    ctx, chunk, args, specs = cs._bench_inputs(uni, torch.device("cuda"))
    n0 = red.launches_here()
    eng = HaloEngine(ctx, chunk, specs, torch.device("cuda"))
    eng.process(**args)
    torch.cuda.synchronize()
    st = eng.stats
    assert sum(st.k3_launches_by_group.values()) == red.launches_here() - n0 > 0
    # every kind of family: the bound subhalo, SOs, both apertures, projections
    kinds = {g.split("/")[0] for g in st.k3_launches_by_group}
    assert kinds == {"BoundSubhalo", "SO", "ExclusiveSphere", "InclusiveSphere",
                     "ProjectedAperture"}, st.k3_launches_by_group
