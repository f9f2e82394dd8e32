"""ViT (Dosovitskiy et al. 2021): CLS token first, pre-norm blocks.  The
global feature is the CLS token, the patch tokens follow it."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import Conv, Dense, LayerNorm, attention

MODULE = "vit"  # the program's name for the net: backbone.backbone.vit


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, precision):
        super().__init__()
        self.proj = Conv(dim, patch, precision)


class ViTAttention(nn.Module):
    def __init__(self, dim, heads, precision):
        super().__init__()
        self.heads, self.precision = heads, precision
        self.qkv = Dense(dim, 3 * dim, precision)
        self.proj = Dense(dim, dim, precision)

    def forward(self, x):
        b, t, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).reshape(b, t, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        o = attention(qkv[0] * d ** -0.5, qkv[1], qkv[2], self.precision)
        return self.proj(o.permute(0, 2, 1, 3).reshape(b, t, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, precision):
        super().__init__()
        self.fc1 = Dense(dim, hidden, precision)
        self.fc2 = Dense(hidden, dim, precision)


class ViTBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, eps, precision):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps)
        self.attn = ViTAttention(dim, heads, precision)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), precision)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class ViT(nn.Module):
    def __init__(self, arch: dict, precision: str):
        super().__init__()
        dim, eps = arch["embed_dim"], 1e-6
        n = (arch["img_size"] // arch["patch_size"]) ** 2
        self.patch_embed = PatchEmbed(dim, arch["patch_size"], precision)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + n, dim))
        self.block_names = [f"blocks_{i}" for i in range(arch["depth"])]
        for name in self.block_names:
            self.add_module(name, ViTBlock(dim, arch["num_heads"], arch["mlp_ratio"], eps,
                                           precision))
        self.norm = LayerNorm(dim, eps)

    def stem(self, images):
        x = self.patch_embed.proj(images)
        b, h, w, d = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, d), x.reshape(b, h * w, d)], dim=1)
        return x + self.pos_embed

    def body(self, x):
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.norm(x)


Net = ViT


def features(tokens):
    """Final tokens -> (patch tokens [B, N, D], global feature [B, D])."""
    return tokens[:, 1:], tokens[:, 0]
