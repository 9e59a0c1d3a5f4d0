"""PyTorch port, input pipeline: the threaded loader and its ring of host
buffers, the ERA5 reader (h5py and native), the archive statistics, the
loader dispatch and the prefetch, each against its JAX counterpart on the
same numpy inputs (bit for bit where the arithmetic is the same) at small
sizes.

The port's native reader is built into a temporary directory here (its
``BUILD_DIR`` patched per module), so the tests never write into the
package's build directory.
"""

import shutil
import subprocess
import sys
import threading

import h5py
import numpy as np
import pytest
import torch

from swin_v2_weather_tpu.data import era5 as jax_era5
from swin_v2_weather_tpu.data import pipeline as jax_pipeline
from swin_v2_weather_tpu.data import stats as jax_stats
from swin_v2_weather_tpu.data import synthetic as jax_synthetic
from swin_v2_weather_torch.data import era5, pipeline, preprocess, stats, synthetic
from swin_v2_weather_torch.data.native import reader

torch.set_num_threads(1)


class FakeParams(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def get(self, k, default=None):
        return dict.get(self, k, default)


@pytest.fixture(scope="module", autouse=True)
def native_build_dir(tmp_path_factory):
    """The port's native reader builds into a temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setattr(reader, "BUILD_DIR", str(tmp_path_factory.mktemp("native_build")))
    yield
    mp.undo()


# --------------------------------------------------------------------------
# an ERA5-shaped archive: two yearly files, 2016 a leap year
# --------------------------------------------------------------------------

T, C, H, W = 12, 5, 9, 16  # tiny "year" files; H = 9 -> crop to 8


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("era5")
    rng = np.random.default_rng(0)
    for year in (2015, 2016):
        t = T + (4 if year % 4 == 0 else 0)
        fields = rng.standard_normal((t, C, H, W)).astype(np.float32)
        with h5py.File(root / f"{year}.h5", "w") as f:
            f.create_dataset("fields", data=fields)
    np.save(root / "global_means.npy", rng.standard_normal((1, C, 1, 1)).astype(np.float32))
    np.save(root / "global_stds.npy", (0.5 + rng.random((1, C, 1, 1))).astype(np.float32))
    return root


def era5_params(data_dir, **over):
    p = FakeParams(
        dt=1, n_future=0, in_channels=[0, 1, 2, 3], out_channels=[1, 3], img_size=[8, 16],
        add_zenith=False, global_means_path=str(data_dir / "global_means.npy"),
        global_stds_path=str(data_dir / "global_stds.npy"), use_native_loader=False,
        seed=333, data_loader_config="threaded", batch_size=3, num_data_workers=2,
        prefetch_depth=2,
    )
    p.update(over)
    return p


def synthetic_params(**over):
    p = FakeParams(
        dt=1, n_future=0, in_channels=[0, 1, 2], out_channels=[0, 1, 2], img_size=[16, 32],
        add_zenith=True, seed=333, data_loader_config="synthetic", batch_size=3,
        num_data_workers=2, prefetch_depth=2, n_synthetic_samples=16,
    )
    p.update(over)
    return p


ERA5_CASES = {
    "plain": {},
    "noncontiguous": {"in_channels": [0, 2, 4], "out_channels": [1, 4]},
    # a decreasing channel list: JAX's h5py path cannot index it, its native
    # reader can; the port's h5py path is held to JAX's native one, on raw
    # fields (the native reader multiplies by 1 / std where h5py divides)
    "reordered": {"in_channels": [3, 0, 2], "out_channels": [4, 0], "host_normalize": False},
    "2step": {"n_future": 1},
    "zenith-2step": {"add_zenith": True, "n_future": 1, "dt": 2},
    "device-normalized": {"host_normalize": False, "add_zenith": True},
}


@pytest.mark.parametrize("case", list(ERA5_CASES))
def test_era5_samples_match_jax(data_dir, case):
    """Every sample of both years (the leap year's 16 included, the clamped
    indices at each year's end) bit-equal to JAX's reader: channel selection
    in order, crop, host normalization (or none), multi-step targets, zenith."""
    p = era5_params(data_dir, **ERA5_CASES[case])
    ours = era5.Era5Dataset(p, str(data_dir), train=True)
    if case == "reordered":
        if shutil.which("g++") is None:
            pytest.skip("no g++ on this machine: JAX's native reader cannot be built")
        p = era5_params(data_dir, **ERA5_CASES[case], use_native_loader=True)
    ref = jax_era5.Era5Dataset(p, str(data_dir), train=True)
    assert ours._native is None
    assert ours.n_samples_year == ref.n_samples_year == [T, T + 4]
    assert ours.year_offsets == ref.year_offsets and len(ours) == len(ref) == 2 * T + 4
    assert ours.sample_shapes == ref.sample_shapes
    for idx in range(len(ours)):
        assert ours.locate(idx) == ref.locate(idx)
        for a, b in zip(ours[idx], ref[idx], strict=True):
            np.testing.assert_array_equal(a, b)


def test_era5_missing_dir_raises(data_dir, tmp_path):
    with pytest.raises(FileNotFoundError):
        era5.Era5Dataset(era5_params(data_dir), str(tmp_path / "empty"), train=True)


def test_device_normalization_matches_host(data_dir):
    """``host_normalize: false`` reads raw fields; the port's Preprocessor
    z-scores them on the batch's device to the host-normalized values
    (fp32: the same two operations, in the same order)."""
    over = dict(ERA5_CASES["noncontiguous"], add_orography=False, add_landmask=False)
    host = era5.Era5Dataset(era5_params(data_dir, **over), str(data_dir), train=True)
    p_dev = era5_params(data_dir, host_normalize=False, **over)
    dev = era5.Era5Dataset(p_dev, str(data_dir), train=True)
    batch = {k: torch.from_numpy(v[None]) for k, v in zip(("inp", "tar"), dev[7])}
    inp, tar, _ = preprocess.Preprocessor(p_dev)(batch)
    np.testing.assert_allclose(inp[0].numpy(), host[7][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tar[0].numpy(), host[7][1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_future", [0, 1])
def test_native_reader_equals_h5py(data_dir, n_future):
    """The native pread reader (built with g++ at first use) gives the h5py
    path's raw samples bit for bit; normalized, it multiplies by 1 / std
    where h5py divides (within an ulp: rtol 1e-6, the bound of JAX's own
    native parity test)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the native reader cannot be built")
    assert reader.native_available()
    assert reader._so_path().startswith(reader.BUILD_DIR)
    for normalize in (True, False):
        over = dict(ERA5_CASES["reordered"], n_future=n_future, add_zenith=True)
        over["host_normalize"] = normalize
        ds_n = era5.Era5Dataset(era5_params(data_dir, use_native_loader=True, **over),
                                str(data_dir), train=True)
        ds_p = era5.Era5Dataset(era5_params(data_dir, **over), str(data_dir), train=True)
        assert ds_n._native is not None and ds_p._native is None
        for idx in (0, 3, T - 1, T + 5, len(ds_n) - 1):
            for a, b in zip(ds_n[idx], ds_p[idx], strict=True):
                if normalize:
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
                else:
                    np.testing.assert_array_equal(a, b)


def test_native_reader_refuses_chunked_files(data_dir, tmp_path):
    """``use_native_loader: true`` refuses chunked files; 'auto' reads them
    through h5py."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the native reader cannot be built")
    path = tmp_path / "chunked_2017.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("fields", data=np.zeros((6, C, H, W), np.float32), chunks=(1, 1, H, W))
    shutil.copy(data_dir / "global_means.npy", tmp_path)
    shutil.copy(data_dir / "global_stds.npy", tmp_path)
    assert reader.probe_files([str(path)]) is None
    with pytest.raises(RuntimeError):
        era5.Era5Dataset(era5_params(tmp_path, use_native_loader=True), str(tmp_path), True)
    ds = era5.Era5Dataset(era5_params(tmp_path, use_native_loader="auto"), str(tmp_path), True)
    assert ds._native is None and ds[2][0].shape == (4, 8, 16)


# --------------------------------------------------------------------------
# archive statistics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 5])
def test_archive_stats_match_jax(data_dir, tmp_path, chunk):
    ours = stats.compute_archive_stats(str(data_dir), chunk=chunk)
    ref = jax_stats.compute_archive_stats(str(data_dir), chunk=chunk)
    assert set(ours) == set(ref) == {"global_means", "global_stds", "time_means",
                                     "time_diff_stds"}
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key])
    stats.write_stats(ours, str(tmp_path / "out"))
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "global_stds.npy"),
                                  ref["global_stds"])


def test_archive_stats_cli(data_dir, tmp_path):
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "swin_v2_weather_torch.data.stats", str(data_dir), str(out),
         "--chunk", "4"], capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    ref = jax_stats.compute_archive_stats(str(data_dir), chunk=4)
    np.testing.assert_array_equal(np.load(out / "time_means.npy"), ref["time_means"])


# --------------------------------------------------------------------------
# the threaded loader
# --------------------------------------------------------------------------


def lockstep(ours, ref):
    """Iterate both loaders together, comparing each batch before the next
    (both reuse their buffers); returns the number of batches."""
    n = 0
    for a, b in zip(ours, ref, strict=True):
        assert set(a) == set(b)
        for key in b:
            assert a[key].dtype == np.float32 and a[key].flags.c_contiguous
            np.testing.assert_array_equal(a[key], b[key])
        n += 1
    return n


@pytest.mark.parametrize("shard_id, num_shards, epoch", [(0, 1, 0), (0, 1, 3), (1, 2, 5),
                                                         (2, 3, 1)])
@pytest.mark.parametrize("path", ["collated", "pooled"])
def test_loader_batches_match_jax(data_dir, path, shard_id, num_shards, epoch):
    """The same batches in the same order as JAX's ThreadedLoader for the same
    (seed, epoch, shard, num_shards): the collate path (the synthetic
    dataset) and the pooled ring (the ERA5 reader's ``read_into``)."""
    if path == "collated":
        p = synthetic_params(n_future=1)
        ours_ds, ref_ds = synthetic.SyntheticDataset(p), jax_synthetic.SyntheticDataset(p)
    else:
        p = era5_params(data_dir, add_zenith=True, n_future=1)
        ours_ds = era5.Era5Dataset(p, str(data_dir), train=True)
        ref_ds = jax_era5.Era5Dataset(p, str(data_dir), train=True)
    kw = dict(batch_size=3, shard_id=shard_id, num_shards=num_shards, shuffle=True, seed=7,
              num_workers=3, prefetch_batches=2)
    ours, ref = pipeline.ThreadedLoader(ours_ds, **kw), jax_pipeline.ThreadedLoader(ref_ds, **kw)
    for loader in (ours, ref):
        loader.set_epoch(epoch)
    np.testing.assert_array_equal(ours._shard_indices(), ref._shard_indices())
    assert lockstep(ours, ref) == len(ours) == len(ref) == len(ours_ds) // num_shards // 3
    ours.close()
    ref.close()


def test_loader_shuffle_off_drop_last_and_partition():
    """Sequential order without shuffle, the incomplete trailing batch dropped,
    and an epoch partitioned over the shards."""
    ds = synthetic.SyntheticDataset(synthetic_params(n_synthetic_samples=10))
    loader = pipeline.ThreadedLoader(ds, batch_size=4, shuffle=False, num_workers=2)
    batches = [{k: v.copy() for k, v in b.items()} for b in loader]
    assert len(batches) == len(loader) == 2  # 10 // 4
    np.testing.assert_array_equal(batches[1]["inp"], np.stack([ds[i][0] for i in range(4, 8)]))
    seen = []
    for shard in range(4):
        sharded = pipeline.ThreadedLoader(ds, batch_size=2, shard_id=shard, num_shards=4,
                                          seed=1, num_workers=1)
        sharded.set_epoch(5)
        seen.append(sharded._shard_indices())
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(10))
    with pytest.raises(ValueError, match="cannot fill one batch"):
        pipeline.ThreadedLoader(ds, batch_size=11)


class FakeCopyEvent:
    """Stands for the CUDA event of a batch's host-to-device copies: the copy
    'completes' when the loader waits on it, and the batch's contents are
    checked at that moment against a snapshot taken when it was handed out."""

    def __init__(self, batch, log):
        self.batch, self.log = batch, log
        self.snapshot = {k: v.copy() for k, v in batch.items()}
        self.completed = False

    def synchronize(self):
        for key, want in self.snapshot.items():  # nothing wrote the slot meanwhile
            np.testing.assert_array_equal(self.batch[key], want)
        self.completed = True
        self.log.append(self)


@pytest.mark.parametrize("path", ["collated", "pooled"])
def test_ring_slot_not_refilled_before_its_copy_completed(data_dir, path):
    """A consumer that holds a batch sets its fence; no worker writes the
    batch's slot until the loader has waited on that fence, on both paths and
    across an epoch boundary (the ring outlives the epoch). The fake event
    checks, when it is waited on, that its batch is still what was handed
    out."""
    if path == "collated":
        ds = synthetic.SyntheticDataset(synthetic_params(n_synthetic_samples=30))
    else:
        ds = era5.Era5Dataset(era5_params(data_dir, add_zenith=True), str(data_dir), True)
    loader = pipeline.ThreadedLoader(ds, batch_size=2, num_workers=4, prefetch_batches=1)
    ring = loader._ring_size
    waited, events, last_on_slot = [], [], {}
    for epoch in range(2):
        loader.set_epoch(epoch)
        for batch in loader:
            assert isinstance(batch, pipeline.HostBatch)
            for key in batch:  # the numpy views and the torch tensors share memory
                assert batch.tensors[key].data_ptr() == batch[key].ctypes.data
            slot = batch.tensors["inp"].data_ptr()
            if slot in last_on_slot:  # the slot's previous batch was waited on first
                assert last_on_slot[slot].completed
            event = FakeCopyEvent(batch, waited)
            batch.fence = event
            events.append(event)
            last_on_slot[slot] = event
    assert len(last_on_slot) == ring
    # every slot reused within the two epochs was waited on exactly once
    assert len(waited) == len(events) - ring
    assert len({id(e) for e in waited}) == len(waited)


def test_ring_slot_waits_for_a_slow_copy():
    """The loader blocks on a fence that has not completed yet: the next
    refill of that slot waits until another thread completes the copy."""
    ds = synthetic.SyntheticDataset(synthetic_params(n_synthetic_samples=12))
    loader = pipeline.ThreadedLoader(ds, batch_size=1, num_workers=2, prefetch_batches=1)
    release = threading.Event()

    class SlowEvent:
        def synchronize(self):
            assert release.wait(timeout=30)

    it = iter(loader)
    first = next(it)
    first.fence = SlowEvent()
    timer = threading.Timer(0.2, release.set)
    timer.start()
    try:
        rest = [next(it) for _ in range(loader._ring_size)]  # reaches first's slot again
    finally:
        timer.cancel()
    assert release.is_set() and len(rest) == loader._ring_size


# --------------------------------------------------------------------------
# dispatch and prefetch
# --------------------------------------------------------------------------


def test_get_data_loader_dispatch(data_dir):
    loader, ds = pipeline.get_data_loader(synthetic_params(), "", train=True)
    assert isinstance(ds, synthetic.SyntheticDataset) and loader.shuffle
    assert (ds.img_shape_x, ds.img_shape_y) == (16, 32) and not loader.pin_memory
    for cfg in ("threaded", "pytorch", "dali-es-gpu", "dali"):
        p = era5_params(data_dir, data_loader_config=cfg)
        loader, ds = pipeline.get_data_loader(p, str(data_dir), train=False)
        assert isinstance(ds, era5.Era5Dataset) and not loader.shuffle and len(loader) == 9
    with pytest.raises(ValueError, match="unknown data_loader_config"):
        pipeline.get_data_loader(synthetic_params(data_loader_config="bogus"), "", train=True)


def test_synthetic_dataset_signature_matches_jax():
    p = synthetic_params(n_future=1)
    del p["n_synthetic_samples"]
    ours = synthetic.SyntheticDataset(p, "", train=False, n_samples=5)
    ref = jax_synthetic.SyntheticDataset(p, "", train=False, n_samples=5)
    assert len(ours) == len(ref) == 5 and not ours.train
    assert (ours.img_shape_x, ours.img_shape_y) == (ref.img_shape_x, ref.img_shape_y)
    for a, b in zip(ours[4], ref[4], strict=True):
        np.testing.assert_array_equal(a, b)


def test_cuda_prefetch_on_cpu_yields_the_loaders_batches(data_dir):
    """``device="cpu"``: the loader's batches, unchanged, as CPU tensors the
    caller owns (they survive the ring's reuse)."""
    p = era5_params(data_dir, add_zenith=True)
    ds = era5.Era5Dataset(p, str(data_dir), train=True)
    kw = dict(batch_size=2, seed=3, num_workers=2, prefetch_batches=1)
    ref = [{k: v.copy() for k, v in b.items()} for b in pipeline.ThreadedLoader(ds, **kw)]
    got = list(pipeline.cuda_prefetch(iter(pipeline.ThreadedLoader(ds, **kw)), "cpu", depth=2))
    assert len(got) == len(ref) == 14
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for key in b:
            assert a[key].device.type == "cpu" and a[key].dtype == torch.float32
            np.testing.assert_array_equal(a[key].numpy(), b[key])


def test_cuda_prefetch_without_a_gpu_raises(monkeypatch):
    """No fallback hides the device: asking for CUDA without one raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batches = iter([{"inp": np.zeros((1, 2), np.float32)}])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pipeline.cuda_prefetch(batches, "cuda"))
