"""Host input pipeline: parallel decode -> batched uint8 numpy -> the device.

The port's counterpart of ``ego_moment_cle_vit_tpu/data/pipeline.py``.  The
host only decodes and resizes; batching happens here, and augmentation and
normalization run on the device (``data/augment.py``).

* ``BatchLoader``: epoch-seeded order (numpy ``default_rng([seed, epoch])``,
  the JAX loader's order), ``drop_last``, thread or process decode workers,
  a background thread that loads ``prefetch`` batches ahead, and a disjoint
  stride of the order per process (``process_index`` / ``process_count``,
  given explicitly: the JAX package's multi-host order).  On a mesh
  (``data_shard``) each data rank loads only its row block of every batch the
  one-process loader yields.
* ``HostDecodedCache``: the split decoded once into one host uint8 array.
* ``DevicePrefetcher``: host batches copied to the GPU on a side CUDA stream,
  ``depth`` batches ahead of the step (on a mesh: the rank's rows to the
  rank's device).
* ``shard_batch``: a rank's rows of a global batch, on its device.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel.shard_kernels import check_local_batch
from ..utils.device import resolve_device
from ..utils.trace import span

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
            with span("data.wait"):
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
        data_shard: Optional[Tuple[int, int]] = None,
    ):
        """``batch_size`` is the batch of this process.  With
        ``process_count > 1`` each process takes a disjoint stride of the
        (identically seeded) order.

        ``data_shard=(index, count)``: ``batch_size`` is the global batch,
        and every batch is its rows ``[index * b, (index + 1) * b)`` with ``b =
        batch_size // count``, decoded alone (a data rank of a mesh; the
        trainer's single-host layout, the JAX ``shard_batch``'s rows).

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
        self.rows = None
        if data_shard is not None:
            index, count = data_shard
            if batch_size % count or not 0 <= index < count:
                raise ValueError(f"data shard {index} of {count} of a batch of {batch_size}")
            b = batch_size // count
            self.rows = (index * b, (index + 1) * b)

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
        if self.rows is not None:
            batches = [idxs[self.rows[0]:self.rows[1]] for idxs in batches]
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
    thread.  Yields tuples of tensors.  With a ``mesh`` the host batches are
    global ones and each is cut to this rank's rows (``shard_batch``) before
    it is pinned and copied to the rank's device (``mesh.device``, in place
    of ``device``).

    Usage::

        for images, labels in DevicePrefetcher(loader, depth=2):
            metrics = train_step(state, images, labels, generator)
    """

    def __init__(self, host_iter, device: str | torch.device = "cuda", depth: int = 2,
                 mesh=None):
        self.mesh = mesh
        self.host_iter = host_iter
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.depth = max(1, depth)

    def _host_batches(self):
        for batch in self.host_iter:
            batch = tuple(np.asarray(x) for x in batch)
            yield batch if self.mesh is None else _rows(batch, self.mesh)

    def __iter__(self):
        if self.device.type == "cpu":
            for batch in self._host_batches():
                yield tuple(torch.from_numpy(x) for x in batch)
            return
        consumer = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)

        def produce(put):
            with torch.cuda.device(self.device):
                for batch in self._host_batches():
                    pinned = [torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                              for x in batch]
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


def _rows(batch, mesh):
    """This data rank's rows ``[d * B / D, (d + 1) * B / D)`` of every array."""
    b = check_local_batch(len(batch[0]), mesh)
    lo = mesh.data_index * b
    return tuple(x[lo:lo + b] for x in batch)


def shard_batch(batch, mesh, data_axis: str = "data"):
    """This rank's rows of a global batch (numpy arrays or tensors), as
    tensors on the rank's device: rows ``[d * B / D, (d + 1) * B / D)`` where
    ``d`` is the rank's index on the data axis and ``D`` its size (the JAX
    ``shard_batch``'s block for this rank).  The batch must divide ``D``."""
    if data_axis != "data":
        raise ValueError(f"batches shard over the 'data' axis, not {data_axis!r}")
    return tuple(torch.as_tensor(x).to(mesh.device)
                 for x in _rows(tuple(batch), mesh))
