"""Device-side preprocessing (eval path)."""

from .augment import AugmentConfig, center_crop, dual_view_eval_batch, normalize

__all__ = ["AugmentConfig", "center_crop", "dual_view_eval_batch", "normalize"]
