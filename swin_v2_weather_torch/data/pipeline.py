"""Host input pipeline: sharded, threaded batch assembly into a ring of
(pinned) host buffers, then prefetch onto the GPU on a copy stream.

Counterpart of ``swin_v2_weather_tpu/data/pipeline.py``:

  * **Deterministic epoch-seeded permutation, then shard slice** — every shard
    permutes the full index space with the same ``seed + epoch`` seed and
    takes a strided slice, so an epoch is a partition of the dataset over the
    shards and restarts are reproducible. The batches are the JAX loader's,
    bit for bit. A shard is one index of the mesh's ``data`` axis
    (``data_shard_id`` / ``data_num_shards``, set by the Trainer): ranks that
    differ only in their ``model`` index read the same samples (spatial
    sharding splits each sample over them on the device). JAX shards by
    process instead, one process feeding every chip of its host, so its
    ``process_count`` is the data axis's size here.
  * **Thread-pool sample fetch with look-ahead** — h5py and the native reader
    release the GIL, so a small thread pool overlaps disk I/O and decode with
    the device step.
  * **A ring of batch buffers.** Allocated once per shape as torch tensors,
    page-locked (``pin_memory``) when the batches go to a GPU, and handed to
    the workers as numpy views: datasets with ``read_into`` write their
    samples straight into a slot's rows, the others are stacked into it
    (``np.stack(..., out=)``). A yielded batch (:class:`HostBatch`) is a view
    of its slot; the consumer that copies it out asynchronously sets the
    batch's ``fence``, and the loader waits on that fence before any worker
    writes the slot again.
  * **GPU prefetch** — :func:`cuda_prefetch` issues each batch's host-to-device
    copies with ``non_blocking=True`` on a dedicated ``torch.cuda.Stream``,
    records an event per batch (the slot's fence), and keeps ``depth`` batches
    in flight; the consuming stream waits on the event before it uses the
    batch, and ``record_stream`` ties the device tensors' memory to it.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Dict, Iterator, Optional

import numpy as np
import torch

_SAMPLE_KEYS = ("inp", "tar", "zen_inp", "zen_tar")


class _Slot:
    """One batch buffer of the ring: fp32 torch tensors (page-locked when
    ``pin``), numpy views of the same memory, and the fence the slot's last
    consumer recorded after copying it out."""

    def __init__(self, shapes: Dict[str, tuple], batch_size: int, pin: bool):
        self.tensors = {
            k: torch.empty((batch_size, *s), dtype=torch.float32, pin_memory=pin)
            for k, s in shapes.items()
        }
        for t in self.tensors.values():
            t.zero_()  # first touch once, at allocation, not in the hot loop
        self.arrays = {k: t.numpy() for k, t in self.tensors.items()}
        self.fence = None

    def acquire(self) -> None:
        """Return once the slot's last consumer is done copying it out."""
        fence, self.fence = self.fence, None
        if fence is not None:
            fence.synchronize()


class HostBatch(dict):
    """A batch that lives in a ring slot: the dict maps the keys ``inp / tar
    [/ zen_inp / zen_tar]`` to numpy views of the slot, ``tensors`` to torch
    tensors on the same memory (page-locked when the loader pins). A consumer
    that copies the batch out asynchronously sets ``fence`` to an object whose
    ``synchronize()`` returns once its copies are done (``cuda_prefetch`` sets
    the copies' CUDA event); the loader calls it before it writes the slot
    again. Without a fence the batch stays untouched for the next
    ``ring - prefetch_batches - 1`` (= 2) yields only."""

    def __init__(self, slot: _Slot):
        super().__init__(slot.arrays)
        self._slot = slot

    @property
    def tensors(self) -> Dict[str, torch.Tensor]:
        return self._slot.tensors

    @property
    def fence(self):
        return self._slot.fence

    @fence.setter
    def fence(self, value) -> None:
        self._slot.fence = value


class ThreadedLoader:
    """Iterates dict batches over a sharded, shuffled dataset.

    One epoch per ``__iter__`` call; call :meth:`set_epoch` before each epoch.
    Batches are :class:`HostBatch` views of a ring slot, keyed ``inp / tar
    [/ zen_inp / zen_tar]``; incomplete trailing batches are dropped.
    ``pin_memory`` page-locks the ring (needs a CUDA device).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shard_id: int = 0,
        num_shards: int = 1,
        shuffle: bool = True,
        seed: int = 333,
        num_workers: int = 4,
        prefetch_batches: int = 2,
        pin_memory: bool = False,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = int(seed)
        self.num_workers = max(1, int(num_workers))
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.pin_memory = bool(pin_memory)
        self.epoch = 0

        n_shard = len(dataset) // num_shards
        self.n_steps = n_shard // batch_size
        if self.n_steps == 0:
            raise ValueError(
                f"dataset of {len(dataset)} samples / {num_shards} shards cannot "
                f"fill one batch of {batch_size}"
            )
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.num_workers, thread_name_prefix="era5-loader"
        )
        # the ring leaves 2 consumed batches untouched beyond the look-ahead,
        # so copies without a fence read stable memory (the JAX loader's rule)
        self._ring: Optional[list] = None
        self._ring_size = self.prefetch_batches + 3

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return self.n_steps

    def _shard_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        return order[self.shard_id :: self.num_shards]

    def _ring_for(self, shapes: Dict[str, tuple]) -> list:
        """The ring of slots for per-sample ``shapes`` (reallocated only when
        the shapes change)."""
        if self._ring is not None and (
            set(self._ring[0].arrays) != set(shapes)
            or any(self._ring[0].arrays[k].shape != (self.batch_size, *s)
                   for k, s in shapes.items())
        ):
            self._ring = None
        if self._ring is None:
            self._ring = [_Slot(shapes, self.batch_size, self.pin_memory)
                          for _ in range(self._ring_size)]
        return self._ring

    def __iter__(self) -> Iterator[HostBatch]:
        if hasattr(self.dataset, "read_into") and hasattr(self.dataset, "sample_shapes"):
            yield from self._iter_pooled()
        else:
            yield from self._iter_collated()

    def _iter_collated(self) -> Iterator[HostBatch]:
        """Workers call ``__getitem__``; the samples are stacked into a slot."""
        indices = self._shard_indices()
        n_consumable = self.n_steps * self.batch_size
        lookahead = min((self.prefetch_batches + 1) * self.batch_size, n_consumable)
        futures: collections.deque = collections.deque(
            self._pool.submit(self.dataset.__getitem__, int(indices[i])) for i in range(lookahead)
        )
        submitted = lookahead
        for b in range(self.n_steps):
            samples = []
            for _ in range(self.batch_size):
                samples.append(futures.popleft().result())
                if submitted < n_consumable:
                    futures.append(
                        self._pool.submit(self.dataset.__getitem__, int(indices[submitted]))
                    )
                    submitted += 1
            shapes = {k: np.shape(part) for k, part in zip(_SAMPLE_KEYS, samples[0])}
            slot = self._ring_for(shapes)[b % self._ring_size]
            slot.acquire()
            for key, parts in zip(_SAMPLE_KEYS, zip(*samples)):
                np.stack(parts, out=slot.arrays[key])
            yield HostBatch(slot)

    def _iter_pooled(self) -> Iterator[HostBatch]:
        """Zero-allocation iteration: workers ``read_into`` rows of a slot."""
        ring = self._ring_for(dict(self.dataset.sample_shapes))
        indices = self._shard_indices()
        n_consumable = self.n_steps * self.batch_size

        def fetch(sample_i: int):
            slot = ring[(sample_i // self.batch_size) % self._ring_size]
            row = sample_i % self.batch_size
            self.dataset.read_into(int(indices[sample_i]), {k: a[row] for k, a in slot.arrays.items()})

        def submit(sample_i: int):
            if sample_i % self.batch_size == 0:  # the first write into the slot
                ring[(sample_i // self.batch_size) % self._ring_size].acquire()
            return self._pool.submit(fetch, sample_i)

        lookahead = min((self.prefetch_batches + 1) * self.batch_size, n_consumable)
        futures: collections.deque = collections.deque(submit(i) for i in range(lookahead))
        submitted = lookahead
        for b in range(self.n_steps):
            for _ in range(self.batch_size):
                futures.popleft().result()
                if submitted < n_consumable:
                    futures.append(submit(submitted))
                    submitted += 1
            yield HostBatch(ring[b % self._ring_size])

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


def cuda_prefetch(iterator: Iterator[Dict[str, np.ndarray]], device="cuda", depth: int = 2):
    """Move host batches onto ``device`` ahead of consumption, as dicts of fp32
    tensors.

    On a GPU each batch's copies are issued with ``non_blocking=True`` on a
    dedicated copy stream (from the page-locked ``tensors`` of a
    :class:`HostBatch`, else from the numpy arrays, pageable) and an event is
    recorded after them; ``depth`` batches are in flight at a time. A batch is
    handed out only after the current stream was told to wait on its event,
    and its tensors are ``record_stream``-ed on that stream, so the caching
    allocator reuses their memory only after the consumer's work on them. The
    event is the :class:`HostBatch`'s fence: its slot is not refilled before
    the copies completed; ``device`` is the rank's own (``cuda:LOCAL_RANK``
    under torchrun). With ``device="cpu"`` the batches come back as CPU
    tensors (copies the caller owns), with no stream. A CUDA device that
    does not exist raises; nothing falls back to the CPU.
    """
    device = torch.device(device)
    if device.type == "cpu":
        for batch in iterator:
            yield {k: torch.from_numpy(np.asarray(v)).clone() for k, v in batch.items()}
        return
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"cuda_prefetch: no CUDA device for {device} (pass device='cpu' "
                           "to iterate on the host)")
    copy_stream = torch.cuda.Stream(device)
    in_flight: collections.deque = collections.deque()

    def handed_out(dev_batch, done):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        for t in dev_batch.values():
            t.record_stream(stream)
        return dev_batch

    for batch in iterator:
        src = getattr(batch, "tensors", None)
        if src is None:
            src = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            dev_batch = {k: t.to(device, non_blocking=True) for k, t in src.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        if isinstance(batch, HostBatch):
            batch.fence = done
        in_flight.append((dev_batch, done))
        if len(in_flight) >= depth:
            yield handed_out(*in_flight.popleft())
    while in_flight:
        yield handed_out(*in_flight.popleft())


def get_data_loader(params, location: str, train: bool, pin_memory: bool = False):
    """Loader dispatch (reference ``utils/__init__.py:1-6``).

    ``params.data_loader_config``: ``'threaded'`` (and the reference's
    ``'pytorch'``, ``'dali-es-gpu'``, ``'dali'``) reads the ERA5 HDF5 archive
    (with the native fetch stage per ``params.use_native_loader``);
    ``'synthetic'`` generates deterministic fake data with the same shapes.
    ``pin_memory`` page-locks the loader's ring (batches bound for a GPU).
    Returns ``(loader, dataset)``.
    """
    cfg = str(getattr(params, "data_loader_config", "threaded"))
    if cfg == "synthetic":
        from swin_v2_weather_torch.data.synthetic import SyntheticDataset

        dataset = SyntheticDataset(params, location, train=train)
    elif cfg in ("threaded", "pytorch", "dali-es-gpu", "dali"):
        from swin_v2_weather_torch.data.era5 import Era5Dataset

        dataset = Era5Dataset(params, location, train=train)
    else:
        raise ValueError(f"unknown data_loader_config {cfg!r}")

    loader = ThreadedLoader(
        dataset,
        batch_size=int(getattr(params, "local_batch_size", params.batch_size)),
        shard_id=int(getattr(params, "data_shard_id", 0)),
        num_shards=int(getattr(params, "data_num_shards", 1)),
        shuffle=train,
        seed=int(getattr(params, "seed", 333) or 333),
        num_workers=int(getattr(params, "num_data_workers", 4)),
        prefetch_batches=int(getattr(params, "prefetch_depth", 2)),
        pin_memory=pin_memory,
    )
    return loader, dataset
