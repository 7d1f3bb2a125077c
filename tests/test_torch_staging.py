"""The port's device staging against the JAX package's host staging.

On the seed-11 mock, ``soap_tpu_torch.pipeline.chunk_data.stage_ptype``
must give the same cell-sorted packed store and summed-area tables bit
for bit, and the presize pass the same radii and candidate counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soap_tpu.core.registry import full_property_table
from soap_tpu.pipeline import chunk_data as jcd
from soap_tpu.utils import mock_data
from soap_tpu_torch.pipeline import chunk_data as tcd


@pytest.fixture(scope="module")
def staged():
    uni = mock_data.build_mock_universe(n_halos=12, n_field=8000, boxsize=25.0, seed=11)
    groupnr = np.full(len(uni.ids), -1, dtype=np.int64)
    id_to_row = np.empty(int(uni.ids.max()) + 1, dtype=np.int64)
    id_to_row[uni.ids] = np.arange(len(uni.ids))
    for hi, ids in enumerate(uni.bound_ids):
        groupnr[id_to_row[ids]] = hi
    fields = {
        "Masses": uni.mass.astype(np.float32),
        "Velocities": uni.vel.astype(np.float32),
        "GroupNr_bound": groupnr,
        "FOFGroupIDs": uni.fof_ids,
        "ParticleIDs": uni.ids,  # uint64 bit pattern rides the store too
    }
    jpt = jcd.stage_ptype(uni.pos, fields, uni.boxsize)
    tpt = tcd.stage_ptype(uni.pos, fields, uni.boxsize, torch.device("cpu"))
    return uni, fields, jpt, tpt


def test_stage_ptype_bit_equal(staged):
    _, _, jpt, tpt = staged
    assert tpt.spec.dims == jpt.spec.dims
    assert tpt.spec.cell_size == pytest.approx(jpt.spec.cell_size, rel=0, abs=0)
    assert tpt.row_width == jpt.row_width
    assert tpt.cols_f == jpt.cols_f and tpt.cols_i == jpt.cols_i
    for name in ("offsets", "counts", "sat", "mass_sat"):
        a, b = np.asarray(getattr(jpt, name)), getattr(tpt, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    rows = np.asarray(jpt.packed_lines).reshape(-1, jpt.row_width)
    assert rows.tobytes() == tpt.packed.numpy().tobytes()


@pytest.mark.parametrize(
    "name", ["Masses", "Velocities", "GroupNr_bound", "FOFGroupIDs", "ParticleIDs"]
)
def test_unpack_field_matches_sorted_input(staged, name):
    uni, fields, jpt, tpt = staged
    n = jpt.n
    want = np.asarray(jpt.field(name))[:n]
    got = tcd.unpack_field(tpt.packed, tpt.cols_f, tpt.cols_i, name)[:n].numpy()
    if want.dtype == np.uint64:
        want = want.view(np.int64)  # the port keeps ids as their int64 bits
    np.testing.assert_array_equal(got, want)


def test_chunk_from_numpy_round_trips(staged):
    _, _, jpt, tpt = staged
    jchunk = jcd.ChunkData(boxsize=25.0, ptypes={"PartType1": jpt})
    chunk = tcd.chunk_from_numpy(jchunk, torch.device("cpu"))
    pt = chunk.ptypes["PartType1"]
    assert chunk.boxsize == 25.0 and pt.n == jpt.n and pt.spec == tpt.spec
    for name in ("packed", "offsets", "counts", "sat", "mass_sat"):
        a, b = getattr(pt, name), getattr(tpt, name)
        # compare bits: int bit-halves in the f32 store may read as NaN
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes(), name
    assert np.asarray(jpt.packed_lines).tobytes() == pt.packed.numpy().tobytes()


@pytest.mark.parametrize("presize", [True, False])
def test_presize_and_count_match(staged, presize):
    uni, _, jpt, tpt = staged
    rng = np.random.default_rng(5)
    H = uni.n_halos + 8
    # the catalogue halos plus field points, radii from tiny (the
    # growth ladder runs to its end) to larger than the halo
    centres = np.concatenate([uni.halo_pos, rng.uniform(0, 25.0, (8, 3))])
    chi = centres.astype(np.float32)
    r0 = (rng.uniform(0.001, 1.5, H) * uni.halo_renclose.max()).astype(np.float32)
    eligible = rng.random(H) < 0.8
    rho_crit0 = 3.0 * (100.0 * uni.h) ** 2 / (8.0 * np.pi * mock_data.G_INTERNAL)
    target = 200.0 * rho_crit0 * (uni.omega_m + uni.omega_lambda) / 1.5

    # the truncation count's radius: some above, some below the presized one
    rb = (r0 * rng.uniform(0.3, 3.0, H)).astype(np.float32)

    jchunk = jcd.ChunkData(boxsize=25.0, ptypes={"PartType1": jpt})
    r_j, c_j, b_j = jcd.presize_and_count(
        jchunk, jnp.asarray(chi), jnp.asarray(r0), jnp.asarray(eligible),
        jnp.float32(target), ("PartType1",), presize,
        radius_trunc=jnp.asarray(rb), do_trunc=True,
    )
    tchunk = tcd.ChunkData(boxsize=25.0, ptypes={"PartType1": tpt})
    r_t, c_t, b_t = tcd.presize_and_count(
        tchunk, torch.from_numpy(chi), torch.from_numpy(r0),
        torch.from_numpy(eligible), target, ("PartType1",), presize,
        radius_trunc=torch.from_numpy(rb),
    )
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(c_t[0].numpy(), np.asarray(c_j[0]))
    np.testing.assert_array_equal(b_t[0].numpy(), np.asarray(b_j[0]))
    assert (b_t[0] <= c_t[0]).all() and (b_t[0] < c_t[0]).any()


def _stage_both(tmp, parameter_file=None):
    """One hydro mock staged twice for a spec list (the default hydro one,
    or a shipped parameter file's): by the JAX pipeline from its written
    snapshot and membership file (every cell read, the datasets the JAX
    list needs that the snapshot has, StellarAges derived as
    ``soap_tpu.pipeline.chunks`` derives them), and by the port from the
    in-memory universe.  Returns both and the two lists' wanted datasets."""
    import os

    from soap_tpu.core.params import ParameterFile as JaxParameterFile
    from soap_tpu.io.swift_snapshot import SnapshotMetadata, read_masked_cells
    from soap_tpu.pipeline.chunks import required_datasets as jax_required
    from soap_tpu.pipeline.membership import run_group_membership
    from soap_tpu.pipeline.specs import build_specs as jax_build_specs
    from soap_tpu_torch.core.params import ParameterFile, parameter_file_path
    from soap_tpu_torch.pipeline import chunks as tchunks
    from soap_tpu_torch.pipeline import run as trun
    from soap_tpu_torch.pipeline.specs import build_specs
    from soap_tpu_torch.utils.mock_data import build_mock_universe

    jparams = params = None
    if parameter_file is not None:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jparams = JaxParameterFile(os.path.join(repo, "parameter_files", f"{parameter_file}.yml"))
        params = ParameterFile(parameter_file_path(parameter_file))
    kw = dict(n_halos=5, n_field=2000, boxsize=16.0, seed=61, hydro=True, n_satellites=1)
    sim = mock_data.make_mock_simulation(tmp, **kw)
    mem = os.path.join(tmp, "membership.hdf5")
    run_group_membership(sim["snapshot"], sim["hbt_basename"], mem)
    meta = SnapshotMetadata(sim["snapshot"], [mem])
    ptypes = ["PartType0", "PartType1", "PartType4", "PartType5"]
    fields_per_type = {
        pt: [f for f in tchunks.BASE_FIELDS if f in meta.datasets[pt]] for pt in ptypes
    }
    jspecs = jax_build_specs(jparams, False, meta.virBN98)
    for pt, names in jax_required(jspecs, meta).items():
        fields_per_type[pt] += [n for n in names if n not in fields_per_type[pt]]
    data = read_masked_cells(meta, np.ones(meta.nr_cells, bool), fields_per_type)
    H0 = meta.cosmology_attrs["H0 [internal units]"]
    age_a, age_h0 = meta.cosmology.age_table()
    ages = (age_a.astype(np.float32), (age_h0 / H0).astype(np.float32))
    jax_pts = {}
    for pt in ptypes:
        f = {k: v for k, v in data[pt].items() if k not in ("Coordinates", "__cells__")}
        if pt == "PartType4":
            t_now = np.interp(float(meta.a), *ages)
            f["StellarAges"] = np.maximum(
                t_now - np.interp(f["BirthScaleFactors"], *ages), 0.0
            ).astype(np.float32)
        jax_pts[pt] = jcd.stage_ptype(np.mod(data[pt]["Coordinates"], meta.boxsize), f,
                                      meta.boxsize)
    uni = build_mock_universe(**kw)
    tmeta = trun.mock_metadata(uni)
    specs = build_specs(params, False, tmeta.virBN98)
    host = tchunks.mock_fields(uni, specs, tmeta, ptypes, trun.age_table(tmeta))
    port = tchunks.stage_chunk(host, uni.boxsize, torch.device("cpu"))
    wanted = {ds for s in jspecs for k in s.keys
              for ds in full_property_table()[k].particle_properties}
    return jax_pts, port, wanted, meta


@pytest.fixture(scope="module")
def hydro_staged(tmp_path_factory):
    return _stage_both(str(tmp_path_factory.mktemp("hydro_stage")))[:2]


@pytest.fixture(scope="module", params=["COLIBRE_THERMAL", "FLAMINGO"])
def params_staged(request, tmp_path_factory):
    return _stage_both(str(tmp_path_factory.mktemp("params_stage")), request.param)


def test_parameter_file_staging_bit_equal_to_jax_pipeline(params_staged):
    """A parameter file's list stages the datasets the JAX reader reads:
    those its keys need that the snapshot has (the mock lacks some that
    the lists ask for, and both sides leave them out alike)."""
    jax_pts, port, wanted, meta = params_staged
    have = {f"{pt}/{n}" for pt, d in meta.datasets.items() for n in d}
    assert wanted - have  # the list asks for datasets this snapshot lacks
    for ptype in ("PartType0", "PartType1", "PartType4", "PartType5"):
        jpt, tpt = jax_pts[ptype], port.ptypes[ptype]
        assert (tpt.cols_f, tpt.cols_i) == (jpt.cols_f, jpt.cols_i), ptype
        rows = np.asarray(jpt.packed_lines).reshape(-1, jpt.row_width)
        assert rows.tobytes() == tpt.packed.numpy().tobytes(), ptype


@pytest.mark.parametrize("ptype", ["PartType0", "PartType1", "PartType4", "PartType5"])
def test_hydro_staging_bit_equal_to_jax_pipeline(hydro_staged, ptype):
    jax_pts, port = hydro_staged
    jpt, tpt = jax_pts[ptype], port.ptypes[ptype]
    assert tpt.n == jpt.n > 0
    assert tpt.row_width == jpt.row_width and tpt.cols_f == jpt.cols_f
    assert tpt.cols_i == jpt.cols_i
    for name in ("offsets", "counts", "sat", "mass_sat"):
        assert np.asarray(getattr(jpt, name)).tobytes() == getattr(tpt, name).numpy().tobytes()
    rows = np.asarray(jpt.packed_lines).reshape(-1, jpt.row_width)
    assert rows.tobytes() == tpt.packed.numpy().tobytes()
    if ptype == "PartType0":
        # gas rows are the widest: past 128 columns they pad to 128s
        assert tpt.row_width in (64, 128) and len(tpt.cols_f) > 10


def test_wide_rows_stage_bit_equal(staged):
    """Rows past 128 columns pad to a multiple of 128 (and gather with no
    alignment head), as in the JAX staging."""
    uni, fields, _, _ = staged
    wide = dict(fields, Wide=np.random.default_rng(2).random((len(uni.pos), 130), np.float32))
    jpt = jcd.stage_ptype(uni.pos, wide, uni.boxsize)
    tpt = tcd.stage_ptype(uni.pos, wide, uni.boxsize, torch.device("cpu"))
    assert tpt.row_width == jpt.row_width == 256
    rows = np.asarray(jpt.packed_lines).reshape(-1, jpt.row_width)
    assert rows.tobytes() == tpt.packed.numpy().tobytes()
