"""Vision Transformer backbone (CLS-token family) returning ``[B, 1 + N, D]``.

Counterpart of ``ego_moment_cle_vit_tpu/models/vit.py``: the standard pre-LN
ViT, CLS token first, final LayerNorm applied to every token.  Module and
parameter names follow the flax tree (``blocks_{i}.attn.qkv``,
``blocks_{i}.mlp.fc1``, ``patch_embed.proj``, ``cls_token``, ``pos_embed``
...), so the weight converter maps one to the other name for name.

LayerNorm, the qkv / proj / MLP products and the patch convolution stay plain
PyTorch; the attention goes through one of two kernels, as the JAX package's
``_resolve_attn_path`` picks one (forward and backward CUDA kernels on the
card, their plain versions on the CPU):

* up to ``packed_attention.MAX_TOKENS`` tokens (a 224 input: 197),
  ``kernels.packed_attention.packed_attention`` with one token group per
  image and neither bias nor mask, as the JAX ViT runs
  ``flash_window_attention`` with ``W = 1`` and zero bias and mask;
* longer sequences (a 448 input: 785 tokens),
  ``kernels.flash_attention.flash_attention_tiled``, as the JAX ViT runs
  ``flash_attention_tiled``.

The TPU kernels' ``C % 128`` and VMEM rules are the TPU's and do not apply
here: any width with heads of 32 or 64 takes a kernel, and on the card other
head widths raise.

Training: ``drop_rate`` dropout after the position embedding (the backbone
has nothing else stochastic) and ``remat='block'``, which checkpoints every
``TransformerBlock``.  The JAX package's ``remat='attn'`` only avoided saving
attention probabilities, which the kernel never saves, so here it equals
``'none'``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import flash_attention as _fa
from ..kernels import packed_attention as _pa
from .layers import Dense, Dropout, LayerNorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    drop_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    remat: str = "none"  # 'none' | 'attn' (same as 'none' here) | 'block'

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


VIT_CONFIGS = {
    "vit_micro_patch16_64": ViTConfig(img_size=64, embed_dim=64, depth=2, num_heads=2),
    "vit_tiny_patch16_224": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "vit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "deit_tiny_patch16_224": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vit_base_patch16_224": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "deit_base_patch16_224": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16_224": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
}


class PatchEmbed(nn.Module):
    """Non-overlapping conv patch embedding: [B, H, W, 3] -> [B, N, D]."""

    def __init__(self, patch_size: int, embed_dim: int, dtype, device):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, dtype=dtype,
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2))  # [B, D, h, w]
        return x.flatten(2).transpose(1, 2)


def resolve_attn_path(tokens: int, channels: int, num_heads: int,
                      device: str | torch.device) -> str:
    """'packed' (kernel 3, up to ``MAX_TOKENS`` tokens) or 'tiled' (kernel 6,
    longer sequences) for heads the kernels take.  Other head widths raise on
    the card; on the CPU, where both run their plain versions, they take the
    path their length would."""
    if _pa.kernel_supports(tokens, channels, num_heads):
        return "packed"
    if _fa.kernel_supports(tokens, channels, num_heads):
        return "tiled"
    if torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"attention at C={channels}, heads={num_heads} has heads of neither "
            f"{_pa.HEAD_DIMS}, the widths the attention kernels are compiled for"
        )
    return "packed" if tokens <= _pa.MAX_TOKENS else "tiled"


def attend(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv ``[B, T, 3C]`` -> attention over the whole sequence ``[B, T, C]``
    through the kernel :func:`resolve_attn_path` picks (differentiable)."""
    b, t, c3 = qkv.shape
    if resolve_attn_path(t, c3 // 3, num_heads, qkv.device) == "tiled":
        return _fa.flash_attention_tiled(qkv, num_heads)
    out = _pa.packed_attention(qkv.reshape(b, 1, t, c3), None, None, num_heads)
    return out.reshape(b, t, c3 // 3)


class Attention(nn.Module):
    """qkv -> attention over the whole sequence (packed or q-tiled kernel) -> proj."""

    def __init__(self, dim: int, num_heads: int, dtype, device):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(attend(self.qkv(x), self.num_heads))


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dtype, device):
        super().__init__()
        self.fc1 = Dense(dim, mlp_dim, dtype=dtype, device=device)
        self.fc2 = Dense(mlp_dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, layer_norm_eps: float,
                 dtype, device):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = Attention(dim, num_heads, dtype, device)
        self.norm2 = LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """NHWC images [B, H, W, 3] -> tokens [B, 1 + N, D], CLS first, after the
    final LayerNorm.  ``cls_token`` and ``pos_embed`` stay fp32 and are cast
    at use."""

    def __init__(self, config: ViTConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        cfg = config
        if cfg.remat not in ("none", "attn", "block"):
            raise ValueError(f"Unknown remat policy: {cfg.remat!r}")
        if cfg.embed_dim % cfg.num_heads:
            raise ValueError(f"embed_dim {cfg.embed_dim} is no multiple of {cfg.num_heads} heads")
        self.config = cfg
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim, dtype, device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.embed_dim, dtype=torch.float32, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + cfg.num_patches, cfg.embed_dim, dtype=torch.float32,
                        device=device))
        self.drop = Dropout(cfg.drop_rate)
        self.block_names = [f"blocks_{i}" for i in range(cfg.depth)]
        for name in self.block_names:
            self.add_module(name, TransformerBlock(
                cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.layer_norm_eps, dtype, device))
        self.norm = LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps, device=device)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.patch_embed(images.to(self.dtype))
        b, n, d = x.shape
        if n + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{n} patches from a {tuple(images.shape[1:3])} input, but the position "
                f"embedding was built for {self.pos_embed.shape[1] - 1} (img_size "
                f"{self.config.img_size})")
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, d), x], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        x = self.drop(x, generator)
        remat = self.config.remat == "block" and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if remat:
                # nothing in a block is stochastic, so no RNG state to replay
                x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        return self.norm(x)
