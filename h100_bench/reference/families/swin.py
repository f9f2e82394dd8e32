"""Swin (Liu et al. 2021): shifted windows, relative position bias, patch
merging.  Pooled: the global feature is the mean of the final tokens."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.layers import Conv, Dense, LayerNorm, attention

MODULE = "swin"  # the program's name for the net: backbone.backbone.swin


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_mask(h: int, w: int, hp: int, wp: int, ws: int, shift: int):
    """Additive [nW, T, T] mask, -100 between tokens of different regions of
    the rolled canvas (pad counts as its own region), or None."""
    if shift == 0 and hp == h and wp == w:
        return None
    ids = np.zeros((hp, wp), dtype=np.float32)
    if shift > 0:
        cnt = 1
        for hs in (slice(0, hp - ws), slice(hp - ws, hp - shift), slice(hp - shift, hp)):
            for wsl in (slice(0, wp - ws), slice(wp - ws, wp - shift), slice(wp - shift, wp)):
                ids[hs, wsl] = cnt
                cnt += 1
    pad = np.zeros((hp, wp), dtype=bool)
    pad[h:, :] = True
    pad[:, w:] = True
    if shift > 0:
        pad = np.roll(pad, (-shift, -shift), axis=(0, 1))
    ids[pad] = -1.0
    idw = ids.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = idw[:, None, :] - idw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttentionParams(nn.Module):
    def __init__(self, dim, heads, ws, precision):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, precision)
        self.proj = Dense(dim, dim, precision)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2, heads))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, res, eps, precision):
        super().__init__()
        h, w = res
        ws = min(window, h, w)
        shift = shift if (shift > 0 and min(h, w) > ws) else 0
        if shift >= ws:
            shift = ws // 2
        self.res, self.ws, self.shift, self.heads, self.precision = res, ws, shift, heads, precision
        self.hp, self.wp = -(-h // ws) * ws, -(-w // ws) * ws
        self.norm1 = LayerNorm(dim, eps)
        self.attn = WindowAttentionParams(dim, heads, ws, precision)
        self.norm2 = LayerNorm(dim, eps)
        self.mlp_fc1 = Dense(dim, 4 * dim, precision)
        self.mlp_fc2 = Dense(4 * dim, dim, precision)
        self.index = relative_position_index(ws).reshape(-1)
        self.mask = shift_mask(h, w, self.hp, self.wp, ws, shift)

    def forward(self, x):
        x = x + self.window_attention(self.norm1(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))

    def window_attention(self, xn):
        (h, w), ws, heads, shift = self.res, self.ws, self.heads, self.shift
        hp, wp = self.hp, self.wp
        b, n, c = xn.shape
        d, t = c // heads, ws * ws
        x = xn.reshape(b, h, w, c)
        if hp != h or wp != w:
            x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        qkv = self.attn.qkv(x).reshape(b, hp // ws, ws, wp // ws, ws, 3, heads, d)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, -1, heads, t, d)
        table = self.attn.relative_position_bias_table
        bias = table[torch.as_tensor(self.index, device=xn.device)].reshape(t, t, heads)
        bias = bias.permute(2, 0, 1)[None, None]  # [1, 1, H, T, T]
        if self.mask is not None:
            bias = bias + torch.as_tensor(self.mask, device=xn.device)[None, :, None]
        o = attention(qkv[0] * d ** -0.5, qkv[1], qkv[2], self.precision, bias)
        o = o.reshape(b, hp // ws, wp // ws, heads, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
        o = self.attn.proj(o.reshape(b, hp, wp, c))
        if shift:
            o = torch.roll(o, (shift, shift), dims=(1, 2))
        return o[:, :h, :w].reshape(b, n, c)


class PatchMerging(nn.Module):
    def __init__(self, dim, res, eps, precision):
        super().__init__()
        self.res = res
        self.norm = LayerNorm(4 * dim, eps)
        self.reduction = Dense(4 * dim, 2 * dim, precision, bias=False)

    def forward(self, x):
        (h, w), (b, n, c) = self.res, x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, n // 4, 4 * c)
        return self.reduction(self.norm(x))


class Swin(nn.Module):
    """``stem`` (patch embedding and its norm) and ``body`` (stages, final
    norm) apart, so the dropout between them can take a mask drawn for the
    whole batch."""

    def __init__(self, arch: dict, precision: str):
        super().__init__()
        eps, ws = 1e-5, arch["window_size"]
        dim = arch["embed_dim"]
        self.patch_embed_proj = Conv(dim, arch["patch_size"], precision)
        self.patch_embed_norm = LayerNorm(dim, eps)
        res = (arch["img_size"] // arch["patch_size"],) * 2
        self.layer_names = []
        for stage, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
            for blk in range(depth):
                name = f"stage{stage}_block{blk}"
                self.add_module(name, SwinBlock(dim, heads, ws, 0 if blk % 2 == 0 else ws // 2,
                                                res, eps, precision))
                self.layer_names.append(name)
            if stage < len(arch["depths"]) - 1:
                name = f"stage{stage}_downsample"
                self.add_module(name, PatchMerging(dim, res, eps, precision))
                self.layer_names.append(name)
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
        self.norm = LayerNorm(dim, eps)

    def stem(self, images):
        x = self.patch_embed_proj(images)
        b, h, w, c = x.shape
        return self.patch_embed_norm(x.reshape(b, h * w, c))

    def body(self, x):
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return self.norm(x)


Net = Swin


def features(tokens):
    """Final tokens -> (patch tokens [B, N, D], global feature [B, D])."""
    return tokens, tokens.mean(dim=1)
