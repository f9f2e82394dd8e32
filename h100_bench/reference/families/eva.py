"""EVA-02 (Fang et al. 2023, arXiv:2303.11331), as timm's
``eva02_large_patch14_448`` builds it: CLS token first, pre-norm blocks with
q / k / v apart (``k_proj`` without bias), a 2D rotary embedding of q and k
on the patch tokens, and a SwiGLU MLP with a LayerNorm over its hidden
width.  The global feature is the CLS token, the patch tokens follow it.

The rotary embedding: each head's d channels hold d / 4 bands
``w_j = 10000^(-j / (d/4))``; the patch at grid row r and column c of a
g x g grid sits at ``(r, c) * ref_grid / g`` (timm's ``ref_feat_shape``,
the pretraining grid 224 / 14 = 16); its angles ``[r' w, c' w]``, each
repeated twice in place, give cos and sin ``[N, d]``, and
``rope(x) = x cos + rot(x) sin`` with ``rot(x)_2i = -x_2i+1``,
``rot(x)_2i+1 = x_2i``.  The tables are formed in float64 on each call.

Departures from timm's model: the system's heads (GPF, the moment head and
its classifier) take the final tokens in place of timm's average pool,
``fc_norm`` and 1000-class head; the final LayerNorm is applied to every
token.  Dropout, drop path and the patch dropout are off in serving."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import Conv, Dense, LayerNorm, attention

MODULE = "eva"  # the program's name for the net: backbone.backbone.eva
THETA = 10000.0


def rope_tables(grid: int, ref_grid: int, head_dim: int, device):
    """(cos, sin) [grid * grid, head_dim] in float32, patches row-major."""
    bands = head_dim // 4
    w = THETA ** (-torch.arange(bands, dtype=torch.float64, device=device) / bands)
    pos = torch.arange(grid, dtype=torch.float64, device=device) * ref_grid / grid
    r, c = pos.repeat_interleave(grid), pos.repeat(grid)
    angles = torch.cat([r[:, None] * w, c[:, None] * w], dim=1)
    angles = torch.stack([angles, angles], dim=-1).reshape(grid * grid, head_dim)
    return angles.cos().float(), angles.sin().float()


def rot(x):
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, precision):
        super().__init__()
        self.proj = Conv(dim, patch, precision)


class EVAAttention(nn.Module):
    def __init__(self, dim, heads, precision):
        super().__init__()
        self.heads, self.precision = heads, precision
        self.q_proj = Dense(dim, dim, precision)
        self.k_proj = Dense(dim, dim, precision, bias=False)
        self.v_proj = Dense(dim, dim, precision)
        self.proj = Dense(dim, dim, precision)

    def forward(self, x, cos, sin):
        b, t, c = x.shape
        d = c // self.heads

        def heads(y):
            return y.reshape(b, t, self.heads, d).transpose(1, 2)

        def rope(y):  # the patch tokens only: the CLS token is not rotated
            return torch.cat([y[:, :, :1], y[:, :, 1:] * cos + rot(y[:, :, 1:]) * sin], dim=2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        o = attention(rope(q) * d ** -0.5, rope(k), v, self.precision)
        return self.proj(o.transpose(1, 2).reshape(b, t, c))


class SwiGLU(nn.Module):
    def __init__(self, dim, hidden, eps, precision):
        super().__init__()
        self.fc1_g = Dense(dim, hidden, precision)
        self.fc1_x = Dense(dim, hidden, precision)
        self.norm = LayerNorm(hidden, eps)
        self.fc2 = Dense(hidden, dim, precision)

    def forward(self, x):
        return self.fc2(self.norm(F.silu(self.fc1_g(x)) * self.fc1_x(x)))


class EVABlock(nn.Module):
    def __init__(self, dim, heads, hidden, eps, precision):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps)
        self.attn = EVAAttention(dim, heads, precision)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = SwiGLU(dim, hidden, eps, precision)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm1(x), cos, sin)
        return x + self.mlp(self.norm2(x))


class EVA(nn.Module):
    def __init__(self, arch: dict, precision: str):
        super().__init__()
        dim, eps = arch["embed_dim"], 1e-6
        self.grid = arch["img_size"] // arch["patch_size"]
        self.ref_grid, self.head_dim = arch["rope_ref_grid"], dim // arch["num_heads"]
        self.patch_embed = PatchEmbed(dim, arch["patch_size"], precision)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + self.grid ** 2, dim))
        self.block_names = [f"blocks_{i}" for i in range(arch["depth"])]
        for name in self.block_names:
            self.add_module(name, EVABlock(dim, arch["num_heads"], arch["mlp_hidden"], eps,
                                           precision))
        self.norm = LayerNorm(dim, eps)

    def stem(self, images):
        x = self.patch_embed.proj(images)
        b, h, w, d = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, d), x.reshape(b, h * w, d)], dim=1)
        return x + self.pos_embed

    def body(self, x):
        cos, sin = rope_tables(self.grid, self.ref_grid, self.head_dim, x.device)
        for name in self.block_names:
            x = getattr(self, name)(x, cos, sin)
        return self.norm(x)


Net = EVA


def features(tokens):
    """Final tokens -> (patch tokens [B, N, D], global feature [B, D])."""
    return tokens[:, 1:], tokens[:, 0]
