"""CLE-ViT backbone wrapper and dual-stream module.

Counterpart of ``ego_moment_cle_vit_tpu/models/backbone.py:29-165``.  The
backbone emits ``patch_tokens [B, N, D]`` and ``global_features [B, D]``:
CLS-token models (the ViT family) give token 0 as the global feature and the
rest as patch tokens, pooled-token models (the Swin family) mean-pool their
tokens.  The dual-view pass runs both views as one ``[2B]`` batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from .swin import SWIN_CONFIGS, Swin
from .vit import VIT_CONFIGS, ViT


def _unknown(model_name: str) -> ValueError:
    return ValueError(f"Unknown backbone '{model_name}'. Registered: "
                      f"{sorted(VIT_CONFIGS) + sorted(SWIN_CONFIGS)}")


def backbone_num_features(model_name: str) -> int:
    """Feature dim D for a registered backbone name."""
    if model_name in VIT_CONFIGS:
        return VIT_CONFIGS[model_name].embed_dim
    if model_name in SWIN_CONFIGS:
        return SWIN_CONFIGS[model_name].num_features
    raise _unknown(model_name)


def backbone_num_patches(model_name: str, img_size: int | None = None) -> int:
    """Number of patch tokens N the backbone emits."""
    if model_name in VIT_CONFIGS:
        cfg = VIT_CONFIGS[model_name]
        return ((img_size or cfg.img_size) // cfg.patch_size) ** 2
    if model_name in SWIN_CONFIGS:
        return SWIN_CONFIGS[model_name].num_output_tokens(img_size)
    raise _unknown(model_name)


class CLEViTBackbone(nn.Module):
    """Wraps a registered ViT or Swin; returns patch tokens + global features."""

    def __init__(self, model_name: str, img_size: int | None = None,
                 dtype=torch.float32, device="cpu", drop_rate: float = 0.0,
                 remat: str = "none", attn_kernel: str = "auto"):
        super().__init__()
        if model_name in VIT_CONFIGS:
            cfg = VIT_CONFIGS[model_name]
            net, self.has_cls_token, self.num_features = ViT, True, cfg.embed_dim
        elif model_name in SWIN_CONFIGS:
            cfg = SWIN_CONFIGS[model_name]
            net, self.has_cls_token, self.num_features = Swin, False, cfg.num_features
        else:
            raise _unknown(model_name)
        cfg = dataclasses.replace(cfg, img_size=img_size or cfg.img_size, drop_rate=drop_rate,
                                  remat=remat)
        if not self.has_cls_token:  # Swin only: the fused attention half
            cfg = dataclasses.replace(cfg, attn_kernel=attn_kernel)
        # the module is named like the flax tree: ``vit`` or ``swin``
        self.add_module("vit" if self.has_cls_token else "swin",
                        net(cfg, dtype=dtype, device=device))

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
        """[B, H, W, 3] -> {'patch_tokens': [B, N, D], 'global_features': [B, D]}."""
        if self.has_cls_token:
            features = self.vit(images, generator)
            return {"patch_tokens": features[:, 1:], "global_features": features[:, 0]}
        tokens = self.swin(images, generator)
        return {"patch_tokens": tokens, "global_features": tokens.mean(dim=1)}


class CLEViTDualStream(nn.Module):
    """Shared-weight dual stream: anchor and positive go through one backbone
    as a single ``[2B]`` batch and are split back; ``forward_single`` is the
    serving pass."""

    def __init__(self, model_name: str, img_size: int | None = None,
                 dtype=torch.float32, device="cpu", drop_rate: float = 0.0,
                 remat: str = "none", attn_kernel: str = "auto"):
        super().__init__()
        self.backbone = CLEViTBackbone(model_name, img_size, dtype, device, drop_rate, remat,
                                       attn_kernel)
        self.num_features = self.backbone.num_features

    def forward(
        self, anchor: torch.Tensor, positive: torch.Tensor,
        generator: torch.Generator | None = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        b = anchor.shape[0]
        feats = self.backbone(torch.cat([anchor, positive], dim=0), generator)
        # contiguous halves: the GPF kernel takes each view as its own tensor
        return (
            {k: v[:b].contiguous() for k, v in feats.items()},
            {k: v[b:].contiguous() for k, v in feats.items()},
        )

    def forward_single(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One backbone pass for inference (anchor == positive).  The patch
        tokens are contiguous: the GPF kernel takes them as they are."""
        feats = self.backbone(images)
        feats["patch_tokens"] = feats["patch_tokens"].contiguous()
        return feats
