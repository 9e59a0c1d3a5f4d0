"""PyTorch port, the pure-numpy HDF5 reader and writer (``data/hdf5.py``)
against h5py, and the port's ERA5 dataset, loader, conditioning fields and
archive statistics read without h5py against the h5py path and JAX's.

h5py writes the reference files here (``libver='earliest'``: superblock v0,
symbol-table groups, v1 object headers; ``'latest'``: superblock v3, v2
object headers with link messages); "h5py hidden" is
``sys.modules['h5py'] = None``, so an ``import h5py`` inside the port raises
as on a machine without it. JAX's modules import h5py themselves, so their
references are built before it is hidden. The files are a few hundred KB.
"""

import re
import shutil
import sys

import h5py
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.data import conditioning as jax_conditioning
from swin_v2_weather_tpu.data import era5 as jax_era5
from swin_v2_weather_tpu.data import pipeline as jax_pipeline
from swin_v2_weather_tpu.data import stats as jax_stats
from swin_v2_weather_torch.data import conditioning, era5, hdf5, pipeline, stats
from swin_v2_weather_torch.data.native import reader

from test_torch_data_pipeline import FakeParams, era5_params

torch.set_num_threads(1)

LIBVERS = ["earliest", "latest"]
ARRAYS = {
    "fields": ((3, 4, 5, 6), np.float32),
    "vector64": ((7,), np.float64),
    "plane": ((9, 16), np.float32),
    "cube64": ((2, 3, 4), np.float64),
}


@pytest.fixture(scope="module", autouse=True)
def native_build_dir(tmp_path_factory):
    """The port's native reader builds into a temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setattr(reader, "BUILD_DIR", str(tmp_path_factory.mktemp("native_build")))
    yield
    mp.undo()


def hide_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the native reader cannot be built")


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(dt) for k, (shape, dt) in ARRAYS.items()}


@pytest.fixture(scope="module", params=LIBVERS)
def h5py_file(request, tmp_path_factory):
    """A file of several root datasets, 1-D to 4-D, fp32 and fp64, one of
    them with enough attributes that its header needs a continuation block,
    plus the datasets the reader refuses."""
    root = tmp_path_factory.mktemp("h5")
    path = root / f"{request.param}.h5"
    data = arrays()
    with h5py.File(path, "w", libver=request.param) as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
        for i in range(6):  # after creation: past the header's first chunk
            f["fields"].attrs[f"attribute_{i}"] = np.arange(100)
    # a second file: a group of more than 8 links takes dense storage
    with h5py.File(root / f"{request.param}_refused.h5", "w", libver=request.param) as f:
        f.create_dataset("chunked", data=np.zeros((4, 4), np.float32), chunks=(2, 2))
        f.create_dataset("gzip", data=np.zeros((4, 4), np.float32), compression="gzip")
        f.create_dataset("int32", data=np.zeros((4, 4), np.int32))
        f.create_dataset("big_endian", data=np.zeros(3, ">f4"))
        f.create_dataset("float16", data=np.zeros(3, np.float16))
        f.create_dataset("unwritten", shape=(3,), dtype=np.float32)
    return path, data


def refused_file(path):
    return path.with_name(path.stem + "_refused.h5")


@pytest.mark.parametrize("name", list(ARRAYS))
def test_reader_matches_h5py(h5py_file, name):
    path, data = h5py_file
    offset, shape, dtype = hdf5.dataset_info(str(path), name)
    with h5py.File(path, "r") as f:
        ds = f[name]
        assert offset == ds.id.get_offset()
        assert shape == ds.shape and dtype == ds.dtype
        want = ds[...]
    got = hdf5.read_dataset(str(path), name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data[name])


def test_missing_dataset_raises_key_error(h5py_file):
    path, _ = h5py_file
    with pytest.raises(KeyError, match="absent"):
        hdf5.dataset_info(str(path), "absent")


def test_long_header_has_a_continuation(h5py_file):
    path, _ = h5py_file
    r = hdf5._Reader(str(path))
    try:
        types = [t for t, _, _ in r.messages(r.links()["fields"])]
    finally:
        r.close()
    assert hdf5._CONTINUATION in types and hdf5._LAYOUT in types


REFUSED = {
    "chunked": "chunked layout",
    "gzip": "filter pipeline",
    "int32": "fixed-point (integer) datatype",
    "big_endian": "big-endian",
    "float16": "16-bit float",
    "unwritten": "undefined storage address",
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_reader_refuses_naming_the_feature(h5py_file, name):
    path = refused_file(h5py_file[0])
    with pytest.raises(hdf5.Unsupported, match=re.escape(REFUSED[name])) as info:
        hdf5.dataset_info(str(path), name)
    assert str(path) in str(info.value)


def test_reader_refuses_dense_link_storage(tmp_path):
    path = tmp_path / "dense.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(12):  # past the 8 links a compact group holds
            f.create_dataset(f"d{i}", data=np.zeros(3, np.float32))
    with pytest.raises(hdf5.Unsupported, match="dense link storage"):
        hdf5.dataset_info(str(path), "d1")


@pytest.mark.parametrize("n_datasets", [1, 11])
def test_writer_files_open_in_h5py(tmp_path, n_datasets):
    """h5py opens what ``create_contiguous`` writes and reads the same bytes,
    at the offsets the reader reports; one symbol node holds 11 members."""
    rng = np.random.default_rng(n_datasets)
    specs = {f"v{i:02d}": (((i % 4) + 1,) * ((i % 4) + 1), np.float32 if i % 2 else np.float64)
             for i in range(n_datasets)}
    path = str(tmp_path / "written.h5")
    maps = hdf5.create_contiguous(path, specs)
    data = {}
    for name, mm in maps.items():
        data[name] = rng.standard_normal(mm.shape).astype(mm.dtype)
        mm[...] = data[name]
        mm.flush()
    del maps
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(specs)
        for name, want in data.items():
            ds = f[name]
            assert ds.chunks is None and ds.compression is None
            assert ds.id.get_offset() == hdf5.dataset_info(path, name)[0]
            assert ds.dtype == want.dtype
            np.testing.assert_array_equal(ds[...], want)
    for name, want in data.items():
        np.testing.assert_array_equal(hdf5.read_dataset(path, name), want)


def test_open_dataset_falls_back_to_h5py_only_where_installed(h5py_file, monkeypatch):
    path = refused_file(h5py_file[0])
    with hdf5.open_dataset(str(path), "chunked") as ds:
        assert isinstance(ds, h5py.Dataset) and ds[...].shape == (4, 4)
    with hdf5.open_dataset(str(h5py_file[0]), "plane") as ds:
        assert isinstance(ds, np.memmap)
    hide_h5py(monkeypatch)
    with pytest.raises(hdf5.Unsupported, match="chunked layout"):
        with hdf5.open_dataset(str(path), "chunked"):
            pass


# --------------------------------------------------------------------------
# the data modules with h5py hidden
# --------------------------------------------------------------------------

T, C, H, W = 12, 5, 9, 16


@pytest.fixture(scope="module", params=["h5py", "create_contiguous"])
def archive(request, tmp_path_factory):
    """Two yearly files (2016 a leap year) written by h5py or by the port's
    writer, with the statistics the readers normalize with."""
    root = tmp_path_factory.mktemp(f"era5_{request.param}")
    rng = np.random.default_rng(3)
    for year in (2015, 2016):
        fields = rng.standard_normal((T + (4 if year % 4 == 0 else 0), C, H, W)).astype(
            np.float32)
        if request.param == "h5py":
            with h5py.File(root / f"{year}.h5", "w") as f:
                f.create_dataset("fields", data=fields)
        else:
            mm = hdf5.create_contiguous(str(root / f"{year}.h5"),
                                        {"fields": (fields.shape, np.float32)})["fields"]
            for t in range(fields.shape[0]):  # frame by frame, as a year file is filled
                mm[t] = fields[t]
            mm.flush()
            del mm
    np.save(root / "global_means.npy", rng.standard_normal((1, C, 1, 1)).astype(np.float32))
    np.save(root / "global_stds.npy", (0.5 + rng.random((1, C, 1, 1))).astype(np.float32))
    return root


CASES = {
    "raw": dict(in_channels=[3, 0, 2], out_channels=[4, 0], host_normalize=False,
                add_zenith=True, n_future=1),
    "normalized": dict(in_channels=[0, 1, 2, 3], out_channels=[1, 3], n_future=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_era5_without_h5py_matches_h5py_and_jax(archive, case, monkeypatch):
    """With h5py hidden the dataset reads through the native reader: every
    sample bit-equal to JAX's native reader, and on raw fields to the h5py
    path too (normalized, the native reader multiplies by 1 / std where h5py
    divides)."""
    need_gxx()
    over = CASES[case]
    ref_native = jax_era5.Era5Dataset(era5_params(archive, use_native_loader=True, **over),
                                      str(archive), train=True)
    ours_h5py = era5.Era5Dataset(era5_params(archive, **over), str(archive), train=True)
    assert ref_native._native is not None and ours_h5py._native is None
    via_h5py = [ours_h5py[idx] for idx in range(len(ours_h5py))]
    hide_h5py(monkeypatch)
    ours = era5.Era5Dataset(era5_params(archive, use_native_loader="auto", **over),
                            str(archive), train=True)
    assert ours._native is not None
    assert ours.n_samples_year == ref_native.n_samples_year == [T, T + 4]
    for idx in range(len(ours)):
        for a, b, c in zip(ours[idx], ref_native[idx], via_h5py[idx], strict=True):
            np.testing.assert_array_equal(a, b)
            if case == "raw":
                np.testing.assert_array_equal(a, c)
            else:
                np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-6)


def test_loader_without_h5py_matches_jax(archive, monkeypatch):
    """The pooled loader's batches with h5py hidden, bit-equal to JAX's
    loader over its native reader, in the same order."""
    need_gxx()
    over = dict(add_zenith=True, n_future=1)
    ref_ds = jax_era5.Era5Dataset(era5_params(archive, use_native_loader=True, **over),
                                  str(archive), train=True)
    hide_h5py(monkeypatch)
    ours_ds = era5.Era5Dataset(era5_params(archive, use_native_loader="auto", **over),
                               str(archive), train=True)
    kw = dict(batch_size=3, shard_id=1, num_shards=2, shuffle=True, seed=7, num_workers=3,
              prefetch_batches=2)
    ours, ref = pipeline.ThreadedLoader(ours_ds, **kw), jax_pipeline.ThreadedLoader(ref_ds, **kw)
    for loader in (ours, ref):
        loader.set_epoch(2)
    n = 0
    for a, b in zip(ours, ref, strict=True):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
        n += 1
    assert n == len(ours_ds) // 2 // 3
    ours.close()
    ref.close()


def test_era5_without_h5py_refuses_naming_file_and_reason(tmp_path, monkeypatch, archive):
    """A chunked archive: with h5py hidden the dataset raises, naming the
    file and the feature, where 'auto' would fall back to h5py."""
    path = tmp_path / "chunked_2017.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("fields", data=np.zeros((6, C, H, W), np.float32), chunks=(1, 1, H, W))
    for name in ("global_means.npy", "global_stds.npy"):
        shutil.copy(archive / name, tmp_path)
    ds = era5.Era5Dataset(era5_params(tmp_path, use_native_loader="auto"), str(tmp_path), True)
    assert ds._native is None
    hide_h5py(monkeypatch)
    for mode in ("auto", False):
        with pytest.raises(RuntimeError, match="h5py") as info:
            era5.Era5Dataset(era5_params(tmp_path, use_native_loader=mode), str(tmp_path), True)
        assert str(path) in str(info.value) and "chunked layout" in str(info.value)


@pytest.mark.parametrize("chunk", [1, 5])
def test_archive_stats_without_h5py_match_jax(archive, chunk, monkeypatch):
    ref = jax_stats.compute_archive_stats(str(archive), chunk=chunk)
    hide_h5py(monkeypatch)
    ours = stats.compute_archive_stats(str(archive), chunk=chunk)
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])


@pytest.mark.parametrize("libver", LIBVERS)
def test_conditioning_without_h5py_matches_jax(tmp_path, libver, monkeypatch):
    """Orography (``Z``, [1, H, W] fp32) and the land mask (``LSM``, fp64) in
    HDF5 files as NetCDF-4 writes them: the fields and the static block
    bit-equal to JAX's, read with h5py hidden."""
    rng = np.random.default_rng(5)
    oro, lsm = tmp_path / "orography.nc", tmp_path / "land_mask.nc"
    with h5py.File(oro, "w", libver=libver) as f:
        f.create_dataset("Z", data=(1000 * rng.random((1, 12, 20))).astype(np.float32))
        f.create_dataset("latitude", data=np.linspace(90, -90, 12))
    with h5py.File(lsm, "w", libver=libver) as f:
        f.create_dataset("LSM", data=(rng.random((1, 12, 20)) > 0.6).astype(np.float64))
    params = FakeParams(img_size=[10, 16], add_landmask=True, add_orography=True,
                        landmask_path=str(lsm), orography_path=str(oro))
    ref = (jax_conditioning.get_orography(str(oro)), jax_conditioning.get_land_mask(str(lsm)),
           jax_conditioning.static_features(params))
    hide_h5py(monkeypatch)
    ours = (conditioning.get_orography(str(oro)), conditioning.get_land_mask(str(lsm)),
            conditioning.static_features(params))
    for a, b in zip(ours, ref, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
