"""The port's halo-finder readers against the JAX package's.

``soap_tpu_torch/io/finder_readers.py`` against
``soap_tpu/io/finder_readers.py``: the files of the eight tests of
``tests/test_finder_readers.py`` (VR single- and multi-file, Gadget-4
single- and multi-file with the snapshot's bound ranges, EAGLE SubFind,
Rockstar ASCII and binary, HBTplus sorted), written the same way, read
by both packages: every ``HaloCatalogue`` field and passthrough column
equal in dtype and bytes, and equal ``read_*_groupnr`` tuples.  Each
array half (``vr_catalogue``, ``gadget4_catalogue``,
``subfind_eagle_catalogue``) gives its file function's catalogue from
the same datasets, and the error paths (Hubble != 100, the Rockstar
struct size, missing files) raise the same errors in both packages.
"""

import dataclasses

import h5py
import numpy as np
import pytest

from soap_tpu.io import finder_readers as jfr
from soap_tpu.io import halo_catalogue as jhc
from soap_tpu_torch.io import finder_readers as fr
from soap_tpu_torch.io import halo_catalogue as hc


def _same_array(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _same_catalogue(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "passthrough":
            assert list(a) == list(b)
            for k in b:
                _same_array(a[k], b[k], k)
        elif isinstance(b, np.ndarray):
            _same_array(a, b, f.name)
        else:
            assert a == b, f.name


def _same_tuple(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, np.ndarray):
            _same_array(a, b, f"item {i}")
        else:
            assert a == b, f"item {i}"


# ------------------------------------------------ the test files' writers

def _write_vr(tmp_path, n=5, npart=40):
    rng = np.random.default_rng(1)
    base = str(tmp_path / "vr_catalogue")
    pos = rng.uniform(0, 50, (n, 3))
    with h5py.File(base + ".properties", "w") as f:
        f["Xcminpot"] = pos[:, 0]
        f["Ycminpot"] = pos[:, 1]
        f["Zcminpot"] = pos[:, 2]
        f["R_size"] = rng.uniform(0.5, 2.0, n)
        f["ID"] = np.arange(1, n + 1)
        f["hostHaloID"] = np.array([-1, -1, 1, -1, 2])
        f["Structuretype"] = np.array([10, 10, 15, 10, 15], np.int32)
        f["numSubStruct"] = np.array([1, 1, 0, 0, 0])
        f["npart"] = np.full(n, npart)
    nb = rng.integers(20, npart, n)
    offs = np.concatenate([[0], np.cumsum(nb)[:-1]])
    ids = rng.permutation(np.arange(1, nb.sum() + 1)).astype(np.uint64)
    with h5py.File(base + ".catalog_groups", "w") as f:
        f["Group_Size"] = np.full(n, npart)
        f["Offset"] = offs
        f["Offset_unbound"] = np.zeros(n, np.int64)
    with h5py.File(base + ".catalog_particles", "w") as f:
        f["Particle_IDs"] = ids
    with h5py.File(base + ".catalog_particles.unbound", "w") as f:
        f["Particle_IDs"] = np.zeros(0, np.uint64)
    return base


def _write_vr_multifile(tmp_path, units=None):
    rng = np.random.default_rng(3)
    base = str(tmp_path / "vr_mf")
    units = {"UnitInfo": {"Comoving_or_Physical": 1, "Length_unit_to_kpc": 1000.0}} \
        if units is None else units
    for fi, n in enumerate([3, 2]):
        pos = rng.uniform(0, 50, (n, 3))
        nb = rng.integers(5, 15, n)
        ids = (rng.permutation(np.arange(nb.sum())) + 1000 * fi + 1).astype(np.uint64)
        offs = np.concatenate([[0], np.cumsum(nb)[:-1]])
        with h5py.File(f"{base}.properties.{fi}", "w") as f:
            f["Num_of_files"] = np.array([2])
            f["Xcminpot"] = pos[:, 0]
            f["Ycminpot"] = pos[:, 1]
            f["Zcminpot"] = pos[:, 2]
            f["R_size"] = rng.uniform(0.5, 2.0, n)
            f["ID"] = np.arange(1, n + 1) + 10 * fi
            f["hostHaloID"] = np.full(n, -1)
            f["Structuretype"] = np.full(n, 10, np.int32)
            f["numSubStruct"] = np.zeros(n, np.int64)
            f["npart"] = nb
            for group, attrs in units.items():
                g = f.create_group(group)
                for k, v in attrs.items():
                    g.attrs[k] = v
        with h5py.File(f"{base}.catalog_groups.{fi}", "w") as f:
            f["Num_of_files"] = np.array([2])
            f["Group_Size"] = nb
            f["Offset"] = offs
            f["Offset_unbound"] = np.zeros(n, np.int64)
        with h5py.File(f"{base}.catalog_particles.{fi}", "w") as f:
            f["Num_of_files"] = np.array([2])
            f["Particle_IDs"] = ids
        with h5py.File(f"{base}.catalog_particles.unbound.{fi}", "w") as f:
            f["Num_of_files"] = np.array([2])
            f["Particle_IDs"] = np.zeros(0, np.uint64)
    return base


def _write_gadget4(tmp_path, parameters=None):
    rng = np.random.default_rng(2)
    n = 4
    tab = str(tmp_path / "fof_subhalo_tab_000.hdf5")
    snap = str(tmp_path / "snap_000.hdf5")
    lens = rng.integers(10, 30, (n, 2)).astype(np.int64)
    offs = np.zeros_like(lens)
    offs[:, 0] = np.concatenate([[0], np.cumsum(lens[:, 0])[:-1]])
    offs[:, 1] = np.concatenate([[0], np.cumsum(lens[:, 1])[:-1]])
    with h5py.File(tab, "w") as f:
        g = f.create_group("Subhalo")
        g["SubhaloPos"] = rng.uniform(0, 30, (n, 3))
        g["SubhaloLenType"] = lens
        g["SubhaloOffsetType"] = offs
        g["SubhaloLen"] = lens.sum(axis=1)
        g["SubhaloRankInGr"] = np.array([0, 1, 0, 0])
        g["SubhaloGroupNr"] = np.array([0, 0, 1, 2])
        g["SubhaloHalfmassRad"] = rng.uniform(0.1, 0.5, n)
        if parameters is not None:
            p = f.create_group("Parameters")
            for k, v in parameters.items():
                p.attrs[k] = v
    with h5py.File(snap, "w") as f:
        for t in range(2):
            total = lens[:, t].sum() + 15  # 15 fuzz particles
            f[f"PartType{t}/ParticleIDs"] = np.arange(
                t * 100000, t * 100000 + total, dtype=np.uint64
            )
    return tab, snap


def _write_gadget4_multifile(tmp_path):
    rng = np.random.default_rng(4)
    base = str(tmp_path / "fof_subhalo_tab_007")
    n_files, n_per = 2, 3
    for fi in range(n_files):
        pos = rng.uniform(0, 30, (n_per, 3))
        with h5py.File(f"{base}.{fi}.hdf5", "w") as f:
            f.create_group("Header").attrs["NumFiles"] = np.array([n_files])
            p = f.create_group("Parameters")
            p.attrs["UnitLength_in_cm"] = 3.08567758e24
            p.attrs["Hubble"] = 100.0
            p.attrs["HubbleParam"] = 0.7
            g = f.create_group("Subhalo")
            g["SubhaloPos"] = pos
            g["SubhaloLen"] = np.full(n_per, 20)
            g["SubhaloRankInGr"] = np.zeros(n_per, np.int64)
            g["SubhaloGroupNr"] = np.arange(n_per) + fi * n_per
            g["SubhaloHalfmassRad"] = np.full(n_per, 0.35)
    return base


def _write_subfind_eagle(tmp_path, per_type=False):
    tab = str(tmp_path / "eagle_sub.hdf5")
    with h5py.File(tab, "w") as f:
        g = f.create_group("Subhalo")
        g["CentreOfPotential"] = np.array([[1.0, 2, 3], [4, 5, 6]])
        g["SubLength"] = np.array([100, 50])
        g["SubGroupNumber"] = np.array([0, 1])
        g["GroupNumber"] = np.array([1, 1])
        g["HalfMassRad"] = (np.array([[0.2, 0.1, 0.0, 0.3, 0.0, 0.0],
                                      [0.1, 0.05, 0.0, 0.02, 0.0, 0.0]])
                            if per_type else np.array([0.2, 0.1]))
    return tab


#: ASCII halo lists: the finder test's, and headers without a parent or
#: particle-count column and with Rockstar's unit suffixes
ROCKSTAR_LISTS = {
    "test": "#ID DescID M200c Vmax Vrms R200c Rs Np X Y Z VX VY VZ PID\n"
            "0 -1 1e12 150 120 250.0 30 500 10.0 20.0 30.0 0 0 0 -1\n"
            "1 -1 1e11 80 70 120.0 20 100 11.0 21.0 31.0 0 0 0 0\n",
    "rvir-no-parents": "#id num_p mvir Rvir(kpc/h) x(Mpc/h) y(Mpc/h) z(Mpc/h)\n"
                       "#a comment line\n"
                       "4 900 1e13 400.5 1.5 2.5 3.5\n"
                       "7 30 1e10 50.25 4.0 5.0 6.0\n",
    "parent-id-no-count": "#ID PARENT_ID X Y Z RS\n"
                          "10 -1 0.5 0.5 0.5 12.0\n"
                          "11 10 0.6 0.4 0.5 3.0\n",
}


def _write_rockstar_list(tmp_path, kind="test"):
    path = tmp_path / "out_0.list"
    path.write_text(ROCKSTAR_LISTS[kind])
    return str(path)


def _write_rockstar_binary(tmp_path, n_chunks=1, per_halo_pad=0):
    rng = np.random.default_rng(6)
    paths = []
    for c in range(n_chunks):
        n = 3
        halos = np.zeros(n, jfr._ROCKSTAR_HALO)
        halos["id"] = np.arange(n) + 10 * c
        halos["pos"][:, :3] = rng.uniform(0, 50, (n, 3)).astype(np.float32)
        halos["r"] = np.array([250.0, 120.0, 300.0], np.float32)
        halos["m"] = np.array([1e12, 1e11, 2e12], np.float32)
        halos["num_p"] = np.array([500, 100, 900])
        header = np.zeros(1, jfr._ROCKSTAR_HEADER)
        header["magic"] = 0xFABFABFA
        header["num_halos"] = n
        header["num_particles"] = 10
        header["h0"] = 0.7
        header["scale"] = 1.0
        header["box_size"] = 50.0
        path = str(tmp_path / f"halos_0.{c}.bin")
        with open(path, "wb") as f:
            f.write(header.tobytes())
            f.write(halos.tobytes())
            f.write(b"\0" * (per_halo_pad * n))
            f.write(np.arange(10, dtype=np.int64).tobytes())
        paths.append(path)
    return paths[0]


def _write_hbt_sorted(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "SortedSubSnap_010.hdf5")
    n = 4
    nbound = np.array([6, 0, 3, 5], np.int64)  # one orphan
    ids = rng.permutation(np.arange(1, nbound.sum() + 1)).astype(np.uint64)
    pots = -rng.uniform(1, 10, nbound.sum())
    with h5py.File(path, "w") as f:
        s = f.create_group("Subhalos")
        s["Nbound"] = nbound
        s["TrackId"] = np.arange(100, 100 + n)
        s["Rank"] = np.array([0, 0, 1, 0])
        s["HostHaloId"] = np.array([0, 1, 0, 2])
        s["Depth"] = np.array([0, 0, 1, 0])
        s["ComovingMostBoundPosition"] = rng.uniform(0, 40, (n, 3))
        s["REncloseComoving"] = rng.uniform(0.1, 1.0, n)
        p = f.create_group("Particles")
        p["ParticleIDs"] = ids
        p["PotentialEnergies"] = pots
        u = f.create_group("Units")
        u["LengthInMpch"] = np.array([1.0])
        u["MassInMsunh"] = np.array([1e10])
        u["VelInKmS"] = np.array([1.0])
    return path


def _datasets(path, group=""):
    with h5py.File(path, "r") as f:
        g = f[group] if group else f
        return {k: np.asarray(v) for k, v in g.items() if isinstance(v, h5py.Dataset)}


# ---------------------------------------------------------------- tests

def test_dispatch_tables_match():
    assert list(hc.CATALOGUE_READERS) == list(jhc.CATALOGUE_READERS)
    assert sorted(hc.GROUPNR_READERS) == sorted(jhc.GROUPNR_READERS) == ["HBTplus", "VR"]
    for name, reader in hc.CATALOGUE_READERS.items():
        assert reader.__name__ == jhc.CATALOGUE_READERS[name].__name__, name


def test_vr_reader(tmp_path):
    base = _write_vr(tmp_path)
    cat = hc.CATALOGUE_READERS["VR"](base, h=0.7)
    _same_catalogue(cat, jhc.CATALOGUE_READERS["VR"](base, h=0.7))
    assert list(cat.passthrough) == ["VR/ID", "VR/Structuretype", "VR/hostHaloID",
                                     "VR/numSubStruct"]
    _same_tuple(hc.GROUPNR_READERS["VR"](base), jhc.GROUPNR_READERS["VR"](base))
    # the array half from the same datasets (no unit attributes)
    _same_catalogue(fr.vr_catalogue(_datasets(base + ".properties"), None, h=0.7), cat)


def test_gadget4_reader(tmp_path):
    tab, snap = _write_gadget4(tmp_path)
    cat = hc.CATALOGUE_READERS["Gadget4"](tab, h=0.7)
    _same_catalogue(cat, jhc.CATALOGUE_READERS["Gadget4"](tab, h=0.7))
    _same_tuple(fr.read_gadget4_groupnr(tab, snap), jfr.read_gadget4_groupnr(tab, snap))
    _same_catalogue(fr.gadget4_catalogue(_datasets(tab, "Subhalo"), {}, h=0.7), cat)


def test_subfind_eagle_reader(tmp_path):
    for per_type in (False, True):
        tab = _write_subfind_eagle(tmp_path, per_type)
        cat = hc.CATALOGUE_READERS["SubfindEagle"](tab, h=0.7)
        _same_catalogue(cat, jhc.CATALOGUE_READERS["SubfindEagle"](tab, h=0.7))
        _same_catalogue(fr.subfind_eagle_catalogue(_datasets(tab, "Subhalo"), h=0.7), cat)
        assert cat.search_radius.tolist() == [0.3 * 4 if per_type else 0.2 * 4,
                                              0.1 * 4 if per_type else 0.1 * 4]


@pytest.mark.parametrize("kind", sorted(ROCKSTAR_LISTS))
def test_rockstar_reader(tmp_path, kind):
    path = _write_rockstar_list(tmp_path, kind)
    _same_catalogue(hc.CATALOGUE_READERS["Rockstar"](path, h=0.7),
                    jhc.CATALOGUE_READERS["Rockstar"](path, h=0.7))


@pytest.mark.parametrize("units", [
    None,
    {"UnitInfo": {"Comoving_or_Physical": 0, "Length_unit_to_kpc": 1.0}},
    {"SimulationInfo": {"Length_unit_to_kpc": 3.0857e3, "Comoving_or_Physical": 1}},
    {"SimulationInfo": {"Period": 100.0}},
], ids=["unitinfo-comoving", "unitinfo-physical", "simulationinfo", "no-units"])
def test_vr_multifile_reader(tmp_path, units):
    base = _write_vr_multifile(tmp_path, units)
    h, a = 0.7, 0.5
    cat = hc.CATALOGUE_READERS["VR"](base, h=h, a=a)
    _same_catalogue(cat, jhc.CATALOGUE_READERS["VR"](base, h=h, a=a))
    _same_tuple(hc.GROUPNR_READERS["VR"](base), jhc.GROUPNR_READERS["VR"](base))
    assert fr._vr_length_conversion(base + ".properties.0", h, a) == \
        jfr._vr_length_conversion(base + ".properties.0", h, a)
    files = [f"{base}.properties.{i}" for i in range(2)]
    assert fr._vr_files(base, "properties") == jfr._vr_files(base, "properties") == files
    columns = {name: np.concatenate([_datasets(p)[name] for p in files])
               for name, _ in fr.VR_COLUMNS}
    with h5py.File(files[0], "r") as f:
        attrs = (dict(f["UnitInfo"].attrs) if "UnitInfo" in f else
                 dict(f["SimulationInfo"].attrs)
                 if "SimulationInfo" in f and "Length_unit_to_kpc" in f["SimulationInfo"].attrs
                 else None)
    _same_catalogue(fr.vr_catalogue(columns, attrs, h, a), cat)
    # the bound lists' array half, from each file's local offsets
    files = [(_datasets(f"{base}.catalog_groups.{i}")["Offset"],
              _datasets(f"{base}.catalog_particles.{i}")["Particle_IDs"]) for i in range(2)]
    _same_tuple(fr.vr_groupnr(files), jhc.GROUPNR_READERS["VR"](base))


def test_gadget4_multifile_reader(tmp_path):
    base = _write_gadget4_multifile(tmp_path)
    for path in (f"{base}.0.hdf5", base):
        assert fr._gadget4_files(path) == jfr._gadget4_files(path)
        cat = hc.CATALOGUE_READERS["Gadget4"](path, h=0.7, a=0.5)
        _same_catalogue(cat, jhc.CATALOGUE_READERS["Gadget4"](path, h=0.7, a=0.5))
    files = fr._gadget4_files(base)
    columns = {name: np.concatenate([_datasets(p, "Subhalo")[name] for p in files])
               for name, _ in fr.GADGET4_COLUMNS}
    with h5py.File(files[0], "r") as f:
        params = dict(f["Parameters"].attrs)
    _same_catalogue(fr.gadget4_catalogue(columns, params, h=0.7, a=0.5), cat)


def test_hbt_sorted_layout(tmp_path):
    path = _write_hbt_sorted(tmp_path)
    _same_tuple(hc.read_hbtplus_groupnr(path, read_potential_energies=True),
                jhc.read_hbtplus_groupnr(path, read_potential_energies=True))
    cat = hc.CATALOGUE_READERS["HBTplus"](path, h=0.68)
    _same_catalogue(cat, jhc.CATALOGUE_READERS["HBTplus"](path, h=0.68))
    assert cat.nr_halos == 3


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_rockstar_binary(tmp_path, n_chunks):
    path = _write_rockstar_binary(tmp_path, n_chunks)
    assert fr._ROCKSTAR_HEADER == jfr._ROCKSTAR_HEADER and fr._ROCKSTAR_HEADER.itemsize == 256
    assert fr._ROCKSTAR_HALO == jfr._ROCKSTAR_HALO and fr._ROCKSTAR_HALO.itemsize == 264
    assert fr._rockstar_binary_files(path) == jfr._rockstar_binary_files(path)
    got, info = fr.read_rockstar_binary(path)
    want, want_info = jfr.read_rockstar_binary(path)
    _same_array(got, want)
    assert info == want_info
    cat = hc.CATALOGUE_READERS["Rockstar"](path, h=0.7)
    _same_catalogue(cat, jhc.CATALOGUE_READERS["Rockstar"](path, h=0.7))
    assert cat.nr_halos == 3 * n_chunks


def _raise(fn, *args, **kw):
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return e.value


@pytest.mark.parametrize("case", [
    "hubble", "struct-size", "missing-vr", "missing-vr-groupnr", "missing-gadget4",
    "missing-subfind-eagle", "missing-rockstar-list", "missing-rockstar-bin",
])
def test_error_paths_match(tmp_path, case):
    """Each error path raises the same exception, with the same message,
    in both packages."""
    if case == "hubble":
        tab, _ = _write_gadget4(tmp_path, {"Hubble": 70.0, "HubbleParam": 0.7})
        args, name = (tab,), "Gadget4"
    elif case == "struct-size":
        args, name = (_write_rockstar_binary(tmp_path, per_halo_pad=8),), "Rockstar"
    else:
        missing = str(tmp_path / "nothing_here")
        name = {"missing-vr": "VR", "missing-vr-groupnr": "VR", "missing-gadget4": "Gadget4",
                "missing-subfind-eagle": "SubfindEagle"}.get(case, "Rockstar")
        args = (missing + (".bin" if case.endswith("bin") else ""),)
    if case == "missing-vr-groupnr":
        ours, theirs = _raise(hc.GROUPNR_READERS[name], *args), \
            _raise(jhc.GROUPNR_READERS[name], *args)
    else:
        ours = _raise(hc.CATALOGUE_READERS[name], *args, h=0.7)
        theirs = _raise(jhc.CATALOGUE_READERS[name], *args, h=0.7)
    assert type(ours) is type(theirs) and str(ours) == str(theirs)
    expected = {"hubble": ValueError, "struct-size": ValueError,
                "missing-rockstar-bin": ValueError}.get(case, FileNotFoundError)
    assert isinstance(ours, expected), repr(ours)
