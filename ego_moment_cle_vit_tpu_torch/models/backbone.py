"""CLE-ViT backbone wrapper and dual-stream module.

Counterpart of ``ego_moment_cle_vit_tpu/models/backbone.py:29-165``.  The
backbone emits ``patch_tokens [B, N, D]`` and ``global_features [B, D]``:
CLS-token models (the ViT and EVA families) give token 0 as the global
feature and the tokens after their prefix (CLS, and DINOv2's registers) as
patch tokens, pooled-token models (the Swin family) mean-pool their tokens.
The dual-view pass runs both views as one ``[2B]`` batch.  The EVA family and
the DINOv2 ViTs have no counterpart in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from .eva import EVA, EVA_CONFIGS
from .swin import SWIN_CONFIGS, Swin
from .vit import DINOV2_CONFIGS, VIT_CONFIGS, ViT

# family: (registries, net); the net's module is named like the family
# (``backbone.backbone.vit`` / ``eva`` / ``swin`` in the state dict); the
# DINOv2 ViTs are ViTs, registered apart from those the JAX package has
FAMILIES = {"vit": ((VIT_CONFIGS, DINOV2_CONFIGS), ViT), "eva": ((EVA_CONFIGS,), EVA),
            "swin": ((SWIN_CONFIGS,), Swin)}


def _registered(model_name: str):
    """(family, registered config) of a backbone name."""
    for family, (registries, _) in FAMILIES.items():
        for configs in registries:
            if model_name in configs:
                return family, configs[model_name]
    raise ValueError(f"Unknown backbone '{model_name}'. Registered: "
                     f"{sorted(n for regs, _ in FAMILIES.values() for c in regs for n in c)}")


def backbone_family(model_name: str) -> str:
    """The family of a registered backbone name."""
    return _registered(model_name)[0]


def backbone_num_features(model_name: str) -> int:
    """Feature dim D for a registered backbone name."""
    family, cfg = _registered(model_name)
    return cfg.num_features if family == "swin" else cfg.embed_dim


def backbone_num_patches(model_name: str, img_size: int | None = None) -> int:
    """Number of patch tokens N the backbone emits."""
    family, cfg = _registered(model_name)
    if family == "swin":
        return cfg.num_output_tokens(img_size)
    return ((img_size or cfg.img_size) // cfg.patch_size) ** 2


class CLEViTBackbone(nn.Module):
    """Wraps a registered ViT, EVA or Swin; returns patch tokens + global
    features.  The net's ``num_prefix_tokens`` (CLS and any registers) lead
    its tokens and are not patch tokens; with none, the tokens are pooled."""

    def __init__(self, model_name: str, img_size: int | None = None,
                 dtype=torch.float32, device="cpu", drop_rate: float = 0.0,
                 remat: str = "none", attn_kernel: str = "auto"):
        super().__init__()
        self.family, cfg = _registered(model_name)
        net = FAMILIES[self.family][1]
        self.num_features = backbone_num_features(model_name)
        cfg = dataclasses.replace(cfg, img_size=img_size or cfg.img_size, drop_rate=drop_rate,
                                  remat=remat)
        if self.family == "swin":  # the fused attention half
            cfg = dataclasses.replace(cfg, attn_kernel=attn_kernel)
        # the module is named like the flax tree: ``vit`` or ``swin`` (and ``eva``)
        self.add_module(self.family, net(cfg, dtype=dtype, device=device))
        self.num_prefix_tokens = getattr(self, self.family).num_prefix_tokens

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
        """[B, H, W, 3] -> {'patch_tokens': [B, N, D], 'global_features': [B, D]}."""
        tokens = getattr(self, self.family)(images, generator)
        if self.num_prefix_tokens:  # CLS first
            return {"patch_tokens": tokens[:, self.num_prefix_tokens:],
                    "global_features": tokens[:, 0]}
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
