"""Device-side preprocessing and dual-view augmentation."""

from .augment import (
    AugmentConfig,
    center_crop,
    dual_view_eval_batch,
    dual_view_train_batch,
    normalize,
)

__all__ = [
    "AugmentConfig",
    "center_crop",
    "dual_view_eval_batch",
    "dual_view_train_batch",
    "normalize",
]
