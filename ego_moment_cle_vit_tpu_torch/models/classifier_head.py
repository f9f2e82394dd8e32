"""Classifier heads fusing global features with moment features.

Counterpart of ``ego_moment_cle_vit_tpu/models/classifier_head.py``:
``ClassifierHead`` (the 'concat', 'add' and 'bilinear' fusions, then a
two-layer MLP), ``MultiScaleClassifierHead`` (three projection scales, each
an MLP to logits, single-head attention over the scales' logits, their mean)
and ``AdaptiveClassifierHead`` (squeeze-and-excitation gate, then a
three-layer MLP).  Norms follow the moment head's switch ('layer', 'batch',
'none').
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Dropout
from .moment_head import _head_norm


def _cat_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # jnp.concatenate promotes mixed dtypes (bf16 global, fp32 moments)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=-1)


class ClassifierHead(nn.Module):
    """[B, d_cls] + [B, d_moment] -> logits [B, num_classes].

    Fusion -> fc1 -> Norm -> GELU -> Drop -> fc2 -> Norm -> GELU -> Drop -> fc_out.
    'bilinear' is x^T W y + b with ``bilinear_kernel [hidden, d_cls,
    d_moment]`` (``nn.Bilinear``'s form), summed in fp32 over W rounded to the
    compute dtype; its automatic hidden size is max((d_cls + d_moment) // 2,
    256), the JAX package's.
    """

    def __init__(self, d_cls: int, d_moment: int, num_classes: int,
                 hidden_dim: int | None = None, fusion_type: str = "concat",
                 norm: str = "layer", dtype=torch.float32, device="cpu",
                 dropout: float = 0.1):
        super().__init__()
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
        elif fusion_type != "bilinear":
            raise ValueError(f"Unknown fusion type: {fusion_type}")
        if hidden_dim is not None:
            hidden = hidden_dim
        elif fusion_type == "bilinear":
            hidden = max((d_cls + d_moment) // 2, 256)
        else:
            hidden = max(fusion_dim // 2, 256)
        if fusion_type == "bilinear":
            fusion_dim = hidden
            # fp32 parameters whatever the compute type, as flax's self.param
            self.bilinear_kernel = nn.Parameter(
                torch.zeros(hidden, d_cls, d_moment, dtype=torch.float32, device=device))
            self.bilinear_bias = nn.Parameter(
                torch.zeros(hidden, dtype=torch.float32, device=device))
        self.fc1 = Dense(fusion_dim, hidden, dtype=dtype, device=device)
        self.norm1 = _head_norm(norm, hidden, device)
        self.fc2 = Dense(hidden, hidden // 2, dtype=dtype, device=device)
        self.norm2 = _head_norm(norm, hidden // 2, device)
        self.fc_out = Dense(hidden // 2, num_classes, dtype=dtype, device=device)

    def _bilinear(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x^T W y + b, one [h*c, m] x [m, B] product (W's own layout, no
        copy of it besides the casts) and a batched dot over c."""
        w = self.bilinear_kernel
        h, c, m = w.shape
        acc = torch.float64 if w.dtype == torch.float64 else torch.float32
        wc = w.to(self.dtype).to(acc)
        t = torch.matmul(wc.reshape(h * c, m), y.to(acc).T).reshape(h, c, -1)  # [h, c, B]
        fused = torch.einsum("hcb,bc->bh", t, x.to(acc)).to(self.dtype)
        return fused + self.bilinear_bias.to(self.dtype)

    def forward(self, cls_features: torch.Tensor, moment_features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.fusion_type == "concat":
            fused = _cat_promoted(cls_features, moment_features)
        elif self.fusion_type == "bilinear":
            fused = self._bilinear(cls_features, moment_features)
        elif self.project:
            fused = self.cls_proj(cls_features) + self.moment_proj(moment_features)
        else:
            fused = cls_features + moment_features
        x = self.drop(F.gelu(self.norm1(self.fc1(fused)), approximate="none"), generator)
        x = self.drop(F.gelu(self.norm2(self.fc2(x)), approximate="none"), generator)
        return self.fc_out(x)


class ScaleAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads=1)`` over ``[B, S, C]``
    with keys and values from the same input: q, k, v and out projections
    (flax DenseGeneral kernels ``[C, 1, C]`` and ``[1, C, C]``), logits
    ``(q / sqrt(C)) k^T``, q divided first as flax does, softmax in the
    compute dtype, then out.  Written as plain products: it is tiny."""

    def __init__(self, dim: int, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.sqrt_dim = math.sqrt(dim)
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(dim, dim, dtype=dtype, device=device,
                                      flax_kernel_shape=(dim, 1, dim), flax_in_axes=1))
        self.out = Dense(dim, dim, dtype=dtype, device=device,
                         flax_kernel_shape=(1, dim, dim), flax_in_axes=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = torch.matmul(self.query(x) / self.sqrt_dim, self.key(x).transpose(-1, -2))
        weights = F.softmax(logits, dim=-1)
        return self.out(torch.matmul(weights, self.value(x)))


class MultiScaleClassifierHead(nn.Module):
    """For each scale i of ``num_scales``: ``cls_proj_i`` to d_cls / 2^i and
    ``moment_proj_i`` to d_moment / 2^i, concatenated -> ``scale_fc_i`` to
    half -> Norm -> GELU -> Drop -> ``scale_out_i`` logits; then
    ``scale_attention`` over the ``[B, S, num_classes]`` logits, mean over S."""

    def __init__(self, d_cls: int, d_moment: int, num_classes: int, num_scales: int = 3,
                 norm: str = "layer", dtype=torch.float32, device="cpu", dropout: float = 0.1):
        super().__init__()
        self.num_scales = num_scales
        self.drop = Dropout(dropout)
        for i in range(num_scales):
            c, m = d_cls // 2**i, d_moment // 2**i
            setattr(self, f"cls_proj_{i}", Dense(d_cls, c, dtype=dtype, device=device))
            setattr(self, f"moment_proj_{i}", Dense(d_moment, m, dtype=dtype, device=device))
            setattr(self, f"scale_fc_{i}", Dense(c + m, (c + m) // 2, dtype=dtype,
                                                 device=device))
            setattr(self, f"scale_norm_{i}", _head_norm(norm, (c + m) // 2, device))
            setattr(self, f"scale_out_{i}", Dense((c + m) // 2, num_classes, dtype=dtype,
                                                  device=device))
        self.scale_attention = ScaleAttention(num_classes, dtype=dtype, device=device)

    def forward(self, cls_features: torch.Tensor, moment_features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        logits = []
        for i in range(self.num_scales):
            x = torch.cat([getattr(self, f"cls_proj_{i}")(cls_features),
                           getattr(self, f"moment_proj_{i}")(moment_features)], dim=-1)
            x = getattr(self, f"scale_norm_{i}")(getattr(self, f"scale_fc_{i}")(x))
            x = self.drop(F.gelu(x, approximate="none"), generator)
            logits.append(getattr(self, f"scale_out_{i}")(x))
        return self.scale_attention(torch.stack(logits, dim=1)).mean(dim=1)


class AdaptiveClassifierHead(nn.Module):
    """Squeeze-and-excitation gated fusion + 3-layer MLP: the concatenated
    features F (width f) gated by sigmoid(``se_fc2``(relu(``se_fc1``(F)))),
    ``se_fc1`` to f / ``reduction_ratio``; then fc1 (f / 2) -> Norm -> GELU ->
    Drop -> fc2 (f / 4) -> Norm -> GELU -> Drop -> fc_out."""

    def __init__(self, d_cls: int, d_moment: int, num_classes: int, reduction_ratio: int = 16,
                 norm: str = "layer", dtype=torch.float32, device="cpu", dropout: float = 0.1):
        super().__init__()
        f = d_cls + d_moment
        self.drop = Dropout(dropout)
        self.se_fc1 = Dense(f, f // reduction_ratio, dtype=dtype, device=device)
        self.se_fc2 = Dense(f // reduction_ratio, f, dtype=dtype, device=device)
        self.fc1 = Dense(f, f // 2, dtype=dtype, device=device)
        self.norm1 = _head_norm(norm, f // 2, device)
        self.fc2 = Dense(f // 2, f // 4, dtype=dtype, device=device)
        self.norm2 = _head_norm(norm, f // 4, device)
        self.fc_out = Dense(f // 4, num_classes, dtype=dtype, device=device)

    def forward(self, cls_features: torch.Tensor, moment_features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        fused = _cat_promoted(cls_features, moment_features)
        gate = torch.sigmoid(self.se_fc2(F.relu(self.se_fc1(fused))))
        x = self.drop(F.gelu(self.norm1(self.fc1(fused * gate)), approximate="none"), generator)
        x = self.drop(F.gelu(self.norm2(self.fc2(x)), approximate="none"), generator)
        return self.fc_out(x)
