"""Eval preprocessing on the device: uint8 -> /255 -> center crop -> normalize.

Counterpart of ``ego_moment_cle_vit_tpu/data/augment.py:229-232, 499-502,
539-562``.  Images stay NHWC.  The training augmentations (random crop,
flip, colour jitter, rotation, mask, tile shuffle) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The eval path's knobs of the JAX package's ``AugmentConfig`` (same
    names and defaults); the training augmentations' knobs arrive with them."""

    input_size: int = 448
    resize_size: int = 600
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


def center_crop(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """[..., S, S, C] -> [..., out, out, C], offset (S - out) // 2."""
    s = img.shape[-3]
    off = (s - out_size) // 2
    return img[..., off : off + out_size, off : off + out_size, :]


def normalize(img: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.mean, dtype=img.dtype, device=img.device)
    std = torch.tensor(cfg.std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def dual_view_eval_batch(images_u8: torch.Tensor, cfg: AugmentConfig):
    """uint8 [B, S, S, 3] -> (anchor, positive) float32 [B, I, I, 3], positive
    is anchor.  The crop is taken before the conversion to float, which gives
    the same values as converting first and moves fewer bytes."""
    img = center_crop(images_u8, cfg.input_size).float() / 255.0
    anchor = normalize(img, cfg)
    return anchor, anchor
