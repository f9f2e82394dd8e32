"""DINOv2 with registers (Oquab et al., "DINOv2: Learning Robust Visual
Features without Supervision", arXiv:2304.07193; Darcet et al., "Vision
Transformers Need Registers", arXiv:2309.16588), as timm builds
``vit_giant_patch14_reg4_dinov2``: pre-norm blocks, LayerNorm eps 1e-6
throughout.

* Stem: a patch convolution with a bias; a position embedding over the
  patches only (timm's ``no_embed_class``), added before the CLS token and
  the four register tokens are put in front: ``[CLS, reg_0..reg_3,
  patches]``.
* Block: ``x = x + ls1 * proj(attn(qkv(norm1(x))))`` (one qkv product with
  a bias, scale d^-1/2), ``x = x + ls2 * fc2(silu(h1) * h2)`` with ``[h1,
  h2] = chunk(fc1(norm2(x)), 2)`` (timm's ``SwiGLUPacked``: SiLU on the
  first half); ``ls1`` and ``ls2`` per-channel LayerScale vectors.
* End: one LayerNorm over every token.  The CLS token is the global
  feature, the patch tokens go to the heads, the registers go nowhere.

Departures from timm's model: the system's heads (GPF, the moment head and
its classifier) take the final tokens in place of timm's head; dropout and
drop path are off.  The family is the four-register model (``REGISTERS``):
``features`` knows the prefix from it."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import Conv, Dense, LayerNorm, attention

MODULE = "vit"  # the program's name for the net: backbone.backbone.vit
REGISTERS = 4


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, precision):
        super().__init__()
        self.proj = Conv(dim, patch, precision)


class Attention(nn.Module):
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


class SwiGLUPacked(nn.Module):
    def __init__(self, dim, hidden, precision):
        super().__init__()
        self.fc1 = Dense(dim, 2 * hidden, precision)
        self.fc2 = Dense(hidden, dim, precision)

    def forward(self, x):
        h1, h2 = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(F.silu(h1) * h2)


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim, heads, hidden, eps, precision):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps)
        self.attn = Attention(dim, heads, precision)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp = SwiGLUPacked(dim, hidden, precision)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DINOv2(nn.Module):
    def __init__(self, arch: dict, precision: str):
        super().__init__()
        if arch["num_registers"] != REGISTERS:
            raise ValueError(f"the dinov2 family has {REGISTERS} registers, the configuration "
                             f"{arch['num_registers']}")
        dim, eps = arch["embed_dim"], 1e-6
        n = (arch["img_size"] // arch["patch_size"]) ** 2
        self.patch_embed = PatchEmbed(dim, arch["patch_size"], precision)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.reg_token = nn.Parameter(torch.empty(1, REGISTERS, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, n, dim))
        self.block_names = [f"blocks_{i}" for i in range(arch["depth"])]
        for name in self.block_names:
            self.add_module(name, Block(dim, arch["num_heads"], arch["mlp_hidden"], eps,
                                        precision))
        self.norm = LayerNorm(dim, eps)

    def stem(self, images):
        x = self.patch_embed.proj(images)
        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d) + self.pos_embed
        return torch.cat([self.cls_token.expand(b, 1, d), self.reg_token.expand(b, -1, d), x],
                         dim=1)

    def body(self, x):
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.norm(x)


Net = DINOv2


def features(tokens):
    """Final tokens -> (patch tokens [B, N, D], global feature [B, D]): CLS
    and the registers are not patch tokens."""
    return tokens[:, 1 + REGISTERS:], tokens[:, 0]
