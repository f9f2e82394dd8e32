"""Classifier head fusing global features with moment features.

Counterpart of ``ego_moment_cle_vit_tpu/models/classifier_head.py:24-160``
(``ClassifierHead``) with the 'concat' and 'add' fusions.  'bilinear', the
multi-scale and the adaptive heads are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Dropout
from .moment_head import _head_norm


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, 'Modules to port', heads)"
    )


class ClassifierHead(nn.Module):
    """[B, d_cls] + [B, d_moment] -> logits [B, num_classes].

    Fusion -> fc1 -> Norm -> GELU -> Drop -> fc2 -> Norm -> GELU -> Drop -> fc_out.
    """

    def __init__(self, d_cls: int, d_moment: int, num_classes: int,
                 hidden_dim: int | None = None, fusion_type: str = "concat",
                 norm: str = "layer", dtype=torch.float32, device="cpu",
                 dropout: float = 0.1):
        super().__init__()
        if fusion_type == "bilinear":
            raise _not_ported("the 'bilinear' classifier fusion")
        self.fusion_type = fusion_type
        self.dtype = dtype
        self.drop = Dropout(dropout)
        if fusion_type == "concat":
            fusion_dim = d_cls + d_moment
        elif fusion_type == "add":
            fusion_dim = d_moment
            self.project = d_cls != d_moment
            if self.project:
                self.cls_proj = Dense(d_cls, d_moment, dtype=dtype, device=device)
                self.moment_proj = Dense(d_moment, d_moment, dtype=dtype, device=device)
        else:
            raise ValueError(f"Unknown fusion type: {fusion_type}")
        hidden = hidden_dim if hidden_dim is not None else max(fusion_dim // 2, 256)
        self.fc1 = Dense(fusion_dim, hidden, dtype=dtype, device=device)
        self.norm1 = _head_norm(norm, hidden, device)
        self.fc2 = Dense(hidden, hidden // 2, dtype=dtype, device=device)
        self.norm2 = _head_norm(norm, hidden // 2, device)
        self.fc_out = Dense(hidden // 2, num_classes, dtype=dtype, device=device)

    def forward(self, cls_features: torch.Tensor, moment_features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.fusion_type == "concat":
            # jnp.concatenate promotes mixed dtypes (bf16 global, fp32 moments)
            dt = torch.promote_types(cls_features.dtype, moment_features.dtype)
            fused = torch.cat([cls_features.to(dt), moment_features.to(dt)], dim=-1)
        elif self.project:
            fused = self.cls_proj(cls_features) + self.moment_proj(moment_features)
        else:
            fused = cls_features + moment_features
        x = self.drop(F.gelu(self.norm1(self.fc1(fused)), approximate="none"), generator)
        x = self.drop(F.gelu(self.norm2(self.fc2(x)), approximate="none"), generator)
        return self.fc_out(x)


class MultiScaleClassifierHead(nn.Module):
    def __init__(self, *args, **kwargs):
        raise _not_ported("MultiScaleClassifierHead")


class AdaptiveClassifierHead(nn.Module):
    def __init__(self, *args, **kwargs):
        raise _not_ported("AdaptiveClassifierHead")
