"""Swin Transformer backbone returning final-stage tokens ``[B, N, D]``.

Counterpart of ``ego_moment_cle_vit_tpu/models/swin.py``.  Parameter names
follow the flax tree (``stage{s}_block{b}.attn.qkv`` ...), so the weight
converter maps one to the other name for name.

Every block runs one attention path: LayerNorm, pad, roll and the qkv/proj
products stay plain PyTorch, and the attention itself goes through
``kernels.window_attention.window_attention`` (forward and backward CUDA
kernels on the card, their plain versions on the CPU), as the JAX package's
spatial-kernel path does (``swin.py:620-678``).  The relative-position bias is
an index gather from the ``[(2ws-1)^2, H]`` table, differentiable to the table
by plain autograd; the shift mask keeps the -100 floor.  The TPU-only window
packing and the fused attention-half kernel are not ported.

Training: ``drop_rate`` dropout after ``patch_embed_norm`` (the backbone has
nothing else stochastic) and ``remat='block'``, which checkpoints every
``SwinBlock`` (saves its input, recomputes the block in backward).  The JAX
package's ``remat='attn'`` only avoided saving attention probabilities, which
the kernel never saves, so here it equals ``'none'``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import window_attention as _wa
from .layers import Dense, Dropout, LayerNorm


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    drop_rate: float = 0.0
    layer_norm_eps: float = 1e-5
    remat: str = "none"  # 'none' | 'attn' (same as 'none' here) | 'block'

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)

    def num_output_tokens(self, img_size: int | None = None) -> int:
        s = img_size or self.img_size
        out = s // self.patch_size // 2 ** (len(self.depths) - 1)
        return out * out


SWIN_CONFIGS = {
    "swin_micro_patch4_window7_56": SwinConfig(
        img_size=56, embed_dim=128, depths=(1, 1), num_heads=(4, 8)
    ),
    "swin_tiny_patch4_window7_224": SwinConfig(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)
    ),
    "swin_small_patch4_window7_224": SwinConfig(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)
    ),
    "swin_base_patch4_window7_224": SwinConfig(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)
    ),
    "swin_large_patch4_window7_224": SwinConfig(
        embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)
    ),
    "swin_large_patch4_window7_224.ms_in22k_ft_in1k": SwinConfig(
        embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)
    ),
}


def _relative_position_index(ws: int) -> np.ndarray:
    """Static [ws*ws, ws*ws] index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    relative = coords_flat[:, :, None] - coords_flat[:, None, :]
    relative = relative.transpose(1, 2, 0) + (ws - 1)
    return relative[..., 0] * (2 * ws - 1) + relative[..., 1]


def _attn_mask(h: int, w: int, hp: int, wp: int, ws: int, shift: int) -> np.ndarray | None:
    """Additive [nW, ws*ws, ws*ws] mask (0 / -100) for shifted and/or padded
    windows, or None when nothing needs masking.  Region ids are labelled in
    the shifted frame; pad positions get a sentinel id."""
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
    """qkv / proj / relative-position table of one block (flax ``attn``)."""

    def __init__(self, dim: int, num_heads: int, ws: int, dtype, device):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads, dtype=torch.float32, device=device)
        )


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, input_resolution: Tuple[int, int], layer_norm_eps: float,
                 dtype, device):
        super().__init__()
        h, w = input_resolution
        ws = min(window_size, h, w)
        shift = shift_size if (shift_size > 0 and min(h, w) > ws) else 0
        if shift >= ws:
            shift = ws // 2
        self.res = (h, w)
        self.ws, self.shift = ws, shift
        self.hp, self.wp = -(-h // ws) * ws, -(-w // ws) * ws
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5

        self.norm1 = LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = WindowAttentionParams(dim, num_heads, ws, dtype, device)
        self.norm2 = LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype, device=device)

        idx = torch.as_tensor(_relative_position_index(ws).reshape(-1), device=device)
        self.register_buffer("relative_position_index", idx, persistent=False)
        mask = _attn_mask(h, w, self.hp, self.wp, ws, shift)
        self.register_buffer(
            "attn_mask", torch.as_tensor(mask, device=device) if mask is not None else None,
            persistent=False,
        )

    def relative_position_bias(self) -> torch.Tensor:
        """[H, T, T] fp32 bias gathered from the table."""
        nt = self.ws * self.ws
        table = self.attn.relative_position_bias_table.float()
        bias = table[self.relative_position_index].reshape(nt, nt, self.num_heads)
        return bias.permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H*W, C]."""
        h, w = self.res
        b, n, c = x.shape
        hp, wp, shift = self.hp, self.wp, self.shift
        shortcut = x
        xm = self.norm1(x).reshape(b, h, w, c)
        if hp != h or wp != w:
            xm = F.pad(xm, (0, 0, 0, wp - w, 0, hp - h))
        if shift > 0:
            xm = torch.roll(xm, shifts=(-shift, -shift), dims=(1, 2))
        qkv = self.attn.qkv(xm)
        om = _wa.window_attention(
            qkv, self.relative_position_bias(), self.attn_mask, self.num_heads, self.ws,
            self.scale,
        )
        om = self.attn.proj(om)
        if shift > 0:
            om = torch.roll(om, shifts=(shift, shift), dims=(1, 2))
        if hp != h or wp != w:
            om = om[:, :h, :w]
        x = shortcut + om.reshape(b, n, c)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + y


class PatchMerging(nn.Module):
    """Downsample 2x: [B, H*W, C] -> [B, H/2*W/2, 2C]."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], layer_norm_eps: float,
                 dtype, device):
        super().__init__()
        self.res = input_resolution
        self.norm = LayerNorm(4 * dim, eps=layer_norm_eps, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.res
        b, n, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        ).reshape(b, n // 4, 4 * c)
        return self.reduction(self.norm(x))


class Swin(nn.Module):
    """NHWC images [B, H, W, 3] -> final-stage tokens [B, N, D]."""

    def __init__(self, config: SwinConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        cfg = config
        if cfg.remat not in ("none", "attn", "block"):
            raise ValueError(f"Unknown remat policy: {cfg.remat!r}")
        self.config = cfg
        self.dtype = dtype
        self.drop = Dropout(cfg.drop_rate)
        self.patch_embed_proj = nn.Conv2d(
            3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size, dtype=dtype, device=device
        )
        self.patch_embed_norm = LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps, device=device)
        res = (cfg.img_size // cfg.patch_size,) * 2
        dim = cfg.embed_dim
        self.layer_names = []
        for stage, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            for blk in range(depth):
                name = f"stage{stage}_block{blk}"
                self.add_module(name, SwinBlock(
                    dim, heads, cfg.window_size, 0 if blk % 2 == 0 else cfg.window_size // 2,
                    cfg.mlp_ratio, res, cfg.layer_norm_eps, dtype, device,
                ))
                self.layer_names.append(name)
            if stage < len(cfg.depths) - 1:
                name = f"stage{stage}_downsample"
                self.add_module(name, PatchMerging(dim, res, cfg.layer_norm_eps, dtype, device))
                self.layer_names.append(name)
                res = (res[0] // 2, res[1] // 2)
                dim *= 2
        self.norm = LayerNorm(dim, eps=cfg.layer_norm_eps, device=device)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self.patch_embed_proj(x).permute(0, 2, 3, 1)
        b, h, w, c = x.shape
        x = self.patch_embed_norm(x.reshape(b, h * w, c))
        x = self.drop(x, generator)
        remat = self.config.remat == "block" and torch.is_grad_enabled()
        for name in self.layer_names:
            layer = getattr(self, name)
            if remat and isinstance(layer, SwinBlock):
                # nothing in a block is stochastic, so no RNG state to replay
                x = checkpoint(layer, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x)
        return self.norm(x)
