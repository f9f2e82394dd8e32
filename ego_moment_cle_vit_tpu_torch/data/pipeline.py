"""Host input pipeline: parallel decode -> batched uint8 numpy -> the device.

The port's counterpart of ``ego_moment_cle_vit_tpu/data/pipeline.py``.  The
host only decodes and resizes; batching happens here, and augmentation and
normalization run on the device (``data/augment.py``).

* ``BatchLoader``: epoch-seeded order (numpy ``default_rng([seed, epoch])``,
  the JAX loader's order), ``drop_last``, thread or process decode workers,
  a background thread that loads ``prefetch`` batches ahead, and a disjoint
  stride of the order per process (``process_index`` / ``process_count``,
  given explicitly: the port has no multi-host runtime yet).
* ``HostDecodedCache``: the split decoded once into one host uint8 array.
* ``DevicePrefetcher``: host batches copied to the GPU on a side CUDA stream,
  ``depth`` batches ahead of the step.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import not_ported_parallelism, resolve_device

# --- process-pool decode workers ------------------------------------------
# A process pool decodes past the GIL.  Its children run numpy / PIL only:
# they never touch torch's CUDA state, so a parent that already initialized
# CUDA can fork them (a forked child that called into CUDA would fail).

_WORKER_DATASET = None


def _pool_get(idx: int):  # pragma: no cover - runs in child
    return _WORKER_DATASET[int(idx)]


def _spawn_init(dataset):  # pragma: no cover - runs in child
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _fork_pool(dataset, num_workers: int):
    """Process pool whose children serve ``dataset[idx]``.

    Start method (``EMCT_POOL_START``, default ``fork``):

    * ``fork``: the children see the dataset by copy-on-write; the module
      global is set just before the fork, not passed through ``initargs``,
      which would pickle a possibly large byte column once per worker.
      Forking a parent that runs other threads can deadlock a child on an
      inherited lock; prefer ``spawn`` there when the dataset pickles cheaply.
    * ``spawn``: fresh children, the dataset pickled once per worker through
      the initializer.  The calling script's module level must be import-safe
      (``if __name__ == "__main__":``), since spawn imports ``__main__`` again
      in every worker.
    """
    import multiprocessing as mp

    method = os.environ.get("EMCT_POOL_START", "fork")
    if method == "spawn":
        ctx = mp.get_context("spawn")
        return ctx.Pool(max(1, num_workers), initializer=_spawn_init, initargs=(dataset,))

    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    ctx = mp.get_context("fork")
    pool = ctx.Pool(max(1, num_workers))
    _WORKER_DATASET = None
    return pool


def _background(produce, depth: int) -> Iterator:
    """Run ``produce(put)`` on a daemon thread and yield what it puts, through
    a queue of ``depth`` items.  An exception in the producer is raised in the
    consumer; a consumer that stops early releases the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    abandoned = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer is gone, so an
        # abandoned epoch never wedges the producer thread
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        # an exception must surface in the consumer: a silently dead
        # producer would truncate the epoch with no error
        try:
            produce(put)
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            put(e)
        finally:
            put(stop)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
        t.join()
    finally:
        abandoned.set()


class BatchLoader:
    """Iterates (images_u8 [B, S, S, 3], labels [B] int32) numpy batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        worker_type: str = "thread",
        process_index: int = 0,
        process_count: int = 1,
    ):
        """``batch_size`` is the batch of this process.  With
        ``process_count > 1`` each process takes a disjoint stride of the
        (identically seeded) order.

        ``worker_type``: 'thread' (when ``__getitem__`` releases the GIL or
        the dataset is an in-memory cache) or 'process' (a process pool, for
        decode chains held by the GIL)."""
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type: {worker_type!r}")
        if not 0 <= process_index < max(process_count, 1):
            raise ValueError(f"process_index {process_index} outside 0..{process_count - 1}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.worker_type = worker_type
        self.epoch = 0
        self.process_index = process_index
        self.process_count = max(process_count, 1)

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the order per epoch (deterministic resume)."""
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng([self.seed, self.epoch]).permutation(n)
        else:
            order = np.arange(n)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
        return order

    def _load_batch(self, idxs: np.ndarray, pool):
        if self.worker_type == "process":
            samples = pool.map(_pool_get, [int(i) for i in idxs])
        else:
            samples = list(pool.map(self.dataset.__getitem__, idxs))
        images = np.stack([s[0] for s in samples])
        labels = np.asarray([s[1] for s in samples], np.int32)
        return images, labels

    def _make_pool(self):
        if self.worker_type == "process":
            return _fork_pool(self.dataset, self.num_workers)
        return ThreadPoolExecutor(self.num_workers)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._order()
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        with self._make_pool() as pool:
            if self.prefetch <= 0:
                for idxs in batches:
                    yield self._load_batch(idxs, pool)
                return

            def produce(put):
                for idxs in batches:
                    if not put(self._load_batch(idxs, pool)):
                        return

            yield from _background(produce, self.prefetch)


class HostDecodedCache:
    """The whole dataset decoded ONCE into a host uint8 array; after that
    every ``__getitem__`` is a view.

    For splits too large for the GPU-resident ``DeviceDatasetCache`` but small
    enough for host RAM: the decode is paid once a run, not once an epoch.
    Same access surface as the wrapped dataset (``__len__``, ``__getitem__``,
    ``classes``, ``class_to_idx``, ``num_classes``, ``image_size``), so it
    drops into ``BatchLoader`` unchanged.
    """

    def __init__(self, dataset, num_workers: int = 8, worker_type: str = "process",
                 verbose: bool = False):
        n = len(dataset)
        first_img, first_lbl = dataset[0]
        first_img = np.asarray(first_img, np.uint8)
        self.images = np.empty((n,) + first_img.shape, np.uint8)
        self.labels = np.empty((n,), np.int32)
        self.images[0] = first_img
        self.labels[0] = first_lbl

        idxs = list(range(1, n))
        if verbose:
            import time

            t0 = time.perf_counter()
        if worker_type == "process" and n > 64:
            with _fork_pool(dataset, num_workers) as pool:
                for i, (img, lbl) in zip(idxs, pool.imap(_pool_get, idxs, chunksize=32)):
                    self.images[i] = img
                    self.labels[i] = lbl
        else:
            with ThreadPoolExecutor(max(1, num_workers)) as pool:
                for i, (img, lbl) in zip(idxs, pool.map(dataset.__getitem__, idxs)):
                    self.images[i] = img
                    self.labels[i] = lbl
        if verbose:
            print(f"HostDecodedCache: {n} samples ({self.images.nbytes / 1e6:.0f} MB) decoded "
                  f"in {time.perf_counter() - t0:.1f}s")

        # surface passthrough
        self.dataset_name = getattr(dataset, "dataset_name", "unknown")
        self.split = getattr(dataset, "split", None)
        self.classes = getattr(dataset, "classes", None)
        self.class_to_idx = getattr(dataset, "class_to_idx", None)
        self.num_classes = getattr(dataset, "num_classes", len(self.classes or []))
        self.image_size = self.images.shape[1]
        self._info = getattr(dataset, "get_dataset_info", None)

    @property
    def nbytes(self) -> int:
        return self.images.nbytes + self.labels.nbytes

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        return self.images[idx], int(self.labels[idx])

    def get_dataset_info(self) -> dict:
        if self._info is not None:
            return self._info()
        return {"dataset_name": self.dataset_name, "total_samples": len(self)}


def host_cache_fits(num_samples: int, image_size: int, budget_bytes: int) -> bool:
    """Whether a decoded split fits the host-RAM cache budget."""
    return num_samples * image_size * image_size * 3 <= budget_bytes


class DevicePrefetcher:
    """Overlap the host-to-device copy with the step.

    Wraps an iterator of numpy batches.  A transfer thread pins each batch and
    copies it to the GPU on a side CUDA stream, up to ``depth`` batches ahead,
    and records an event after each copy.  The consumer's stream waits on
    that event before it is handed the batch, and each tensor is marked as
    used by the consumer's stream (``record_stream``), so the caching
    allocator does not hand its memory out again while the step still reads
    it.  A pinned buffer is released once the copy from it has been enqueued:
    PyTorch's pinned-memory allocator keeps it from being reused until the
    copy has run.

    With ``device="cpu"`` batches become CPU tensors, in order, without a
    thread.  Yields tuples of tensors.

    Usage::

        for images, labels in DevicePrefetcher(loader, depth=2):
            metrics = train_step(state, images, labels, generator)
    """

    def __init__(self, host_iter, device: str | torch.device = "cuda", depth: int = 2,
                 mesh=None):
        if mesh is not None:
            raise not_ported_parallelism("DevicePrefetcher over a mesh")
        self.host_iter = host_iter
        self.device = resolve_device(device)
        self.depth = max(1, depth)

    def __iter__(self):
        if self.device.type == "cpu":
            for batch in self.host_iter:
                yield tuple(torch.from_numpy(np.asarray(x)) for x in batch)
            return
        consumer = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)

        def produce(put):
            with torch.cuda.device(self.device):
                for batch in self.host_iter:
                    pinned = [torch.from_numpy(np.asarray(x)).pin_memory() for x in batch]
                    with torch.cuda.stream(side):
                        moved = tuple(x.to(self.device, non_blocking=True) for x in pinned)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    if not put((moved, ready)):
                        return

        for moved, ready in _background(produce, self.depth):
            consumer.wait_event(ready)
            for x in moved:
                x.record_stream(consumer)
            yield moved


def create_multi_loaders(
    dataset_names,
    root: str = "./data",
    batch_size: int = 32,
    num_workers: int = 4,
    resize_size: int = 600,
    download: bool = True,
):
    """BatchLoaders for several datasets and all their available splits:
    ``{dataset_name: {split: BatchLoader}}``."""
    from .ufgvc import UFGVCDataset

    all_loaders = {}
    for name in dataset_names:
        loaders = {}
        splits = UFGVCDataset.get_dataset_splits(name, root) or ["train", "val", "test"]
        for split in splits:
            try:
                ds = UFGVCDataset(dataset_name=name, root=root, split=split,
                                  resize_size=resize_size, download=download)
            except (ValueError, FileNotFoundError) as exc:
                print(f"Warning: no loader for {name}-{split}: {exc}")
                continue
            loaders[split] = BatchLoader(ds, batch_size=batch_size, shuffle=(split == "train"),
                                         num_workers=num_workers)
        if loaders:
            all_loaders[name] = loaders
    return all_loaders


def shard_batch(batch, mesh, data_axis: str = "data"):
    """Place a host batch on a device mesh: needs the parallelism item."""
    raise not_ported_parallelism("shard_batch")
