"""Data layer: UFG parquet datasets, device-side dual-view augmentation, and
the host -> device input pipeline."""

from .augment import (
    AugmentConfig,
    center_crop,
    dual_view_eval_batch,
    dual_view_train_batch,
    normalize,
)
from .device_cache import DeviceDatasetCache, device_cache_fits
from .pipeline import (
    BatchLoader,
    DevicePrefetcher,
    HostDecodedCache,
    create_multi_loaders,
    host_cache_fits,
    shard_batch,
)
from .ufgvc import DATASETS, SyntheticUFGDataset, UFGVCDataset, compare_datasets

__all__ = [
    "AugmentConfig",
    "BatchLoader",
    "DATASETS",
    "DeviceDatasetCache",
    "DevicePrefetcher",
    "HostDecodedCache",
    "SyntheticUFGDataset",
    "UFGVCDataset",
    "center_crop",
    "compare_datasets",
    "create_multi_loaders",
    "device_cache_fits",
    "dual_view_eval_batch",
    "dual_view_train_batch",
    "host_cache_fits",
    "normalize",
    "shard_batch",
]
