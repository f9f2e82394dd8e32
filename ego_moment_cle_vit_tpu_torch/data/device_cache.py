"""GPU-resident dataset cache: upload once, gather batches on the device.

The port's counterpart of ``ego_moment_cle_vit_tpu/data/device_cache.py``.
The UFG splits are small (240 to a few thousand images, 0.25-3 GB at 600^2
uint8 and far less at the training resolutions), so the decoded uint8 split
is uploaded once as one tensor, and each batch is gathered on the device with
``index_select``: the host sends one int64 index vector an epoch instead of
every batch's pixels.

Augmentation stays per step and on the device (``data/augment.py``), so every
epoch still sees fresh views.

On a mesh every rank keeps the whole split on its own device and gathers only
its rows of each batch.  The batch is rounded up to a multiple of the data
axis first (the JAX cache's policy: its gather's output is sharded over the
axis), the extra rows wrap-padded from the order as a short tail batch is.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["DeviceDatasetCache", "device_cache_fits"]


def device_cache_fits(num_samples: int, image_size: int, budget_bytes: int = 6 * 1024**3) -> bool:
    """Whether a decoded uint8 split fits the device-memory budget we are
    willing to spend on data (default 6 GB)."""
    return num_samples * image_size * image_size * 3 <= budget_bytes


class DeviceDatasetCache:
    """Iterable over device-resident (images_u8 [B, S, S, 3], labels [B] int32).

    Same surface as ``BatchLoader`` (``len``, ``set_epoch``, iteration, the
    epoch-seeded order, ``drop_last``) and the JAX cache's order: numpy
    ``default_rng([seed, epoch])``, and a short tail batch wrap-padded from
    the order by ``np.resize`` (so a split smaller than the batch pads too).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
            batch_size = -(-batch_size // mesh.data) * mesh.data
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

        # the one-time host decode (threaded, as BatchLoader's)
        n = len(dataset)
        with ThreadPoolExecutor(max(1, num_workers)) as pool:
            samples = list(pool.map(dataset.__getitem__, range(n)))
        images = np.stack([np.asarray(s[0], np.uint8) for s in samples])
        labels = np.asarray([s[1] for s in samples], np.int32)
        del samples
        self._images = torch.from_numpy(images).to(self.device)
        self._labels = torch.from_numpy(labels).to(self.device)
        self._n = n

    @property
    def nbytes(self) -> int:
        return self._images.numel() + 4 * self._labels.numel()

    def __len__(self) -> int:
        if self.drop_last:
            return self._n // self.batch_size
        return -(-self._n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def epoch_indices(self) -> np.ndarray:
        """This epoch's batches as sample indices, ``[len(self), batch]``."""
        if self.shuffle:
            order = np.random.default_rng([self.seed, self.epoch]).permutation(self._n)
        else:
            order = np.arange(self._n)
        rows = []
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idx) < self.batch_size:
                # np.resize cycles `order`, so a split smaller than the batch pads too
                idx = np.concatenate([idx, np.resize(order, self.batch_size - len(idx))])
            rows.append(idx)
        return np.stack(rows).astype(np.int64) if rows else np.zeros((0, self.batch_size),
                                                                     np.int64)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's batches on the device; on a mesh this rank's rows of
        each."""
        idx = self.epoch_indices()
        if self.mesh is not None:
            b = self.batch_size // self.mesh.data
            idx = idx[:, self.mesh.data_index * b:(self.mesh.data_index + 1) * b]
        idx = torch.from_numpy(np.ascontiguousarray(idx)).to(self.device)
        for row in idx:
            yield (torch.index_select(self._images, 0, row),
                   torch.index_select(self._labels, 0, row))
