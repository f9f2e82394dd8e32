"""CLE-ViT backbone wrapper and dual-stream module (Swin branch).

Counterpart of ``ego_moment_cle_vit_tpu/models/backbone.py:53-165``.  The
backbone emits ``patch_tokens [B, N, D]`` and mean-pooled
``global_features [B, D]``.  ViT backbones and the dual-view pass are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from .swin import SWIN_CONFIGS, Swin

_VIT_NAMES = ("vit_", "deit_")


def _not_ported_vit(model_name: str):
    return NotImplementedError(
        f"ViT backbone '{model_name}' is not ported yet (ROADMAP.md, 'Modules to port', "
        "ViT backbone)"
    )


def backbone_num_features(model_name: str) -> int:
    if model_name in SWIN_CONFIGS:
        return SWIN_CONFIGS[model_name].num_features
    if model_name.startswith(_VIT_NAMES):
        raise _not_ported_vit(model_name)
    raise ValueError(f"Unknown backbone '{model_name}'. Registered: {sorted(SWIN_CONFIGS)}")


class CLEViTBackbone(nn.Module):
    """Wraps a registered Swin; returns patch tokens + mean-pooled features."""

    def __init__(self, model_name: str, img_size: int | None = None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        if model_name not in SWIN_CONFIGS:
            backbone_num_features(model_name)  # raises with the right message
        cfg = SWIN_CONFIGS[model_name]
        cfg = dataclasses.replace(cfg, img_size=img_size or cfg.img_size)
        self.swin = Swin(cfg, dtype=dtype, device=device)
        self.num_features = cfg.num_features

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, H, W, 3] -> {'patch_tokens': [B, N, D], 'global_features': [B, D]}."""
        tokens = self.swin(images)
        return {"patch_tokens": tokens, "global_features": tokens.mean(dim=1)}


class CLEViTDualStream(nn.Module):
    """Shared-weight backbone; ``forward_single`` is the serving pass."""

    def __init__(self, model_name: str, img_size: int | None = None,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.backbone = CLEViTBackbone(model_name, img_size, dtype, device)
        self.num_features = self.backbone.num_features

    def forward(self, anchor, positive):
        raise NotImplementedError(
            "the dual-view backbone pass belongs to training, which is not ported yet "
            "(ROADMAP.md, 'Modules to port', training slice)"
        )

    def forward_single(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One backbone pass for inference (anchor == positive)."""
        return self.backbone(images)
