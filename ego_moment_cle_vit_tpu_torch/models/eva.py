"""EVA-02 backbone (CLS-token family) returning ``[B, 1 + N, D]``.

EVA-02 (Fang et al., "EVA-02: A Visual Representation for Neon Genesis",
arXiv:2303.11331) as timm builds ``eva02_large_patch14_448``: a pre-LN
transformer whose blocks differ from the ViT's in three places.

* Attention: separate ``q_proj`` / ``k_proj`` / ``v_proj`` (``k_proj``
  without bias), and a 2D rotary embedding of q and k on the patch tokens
  (the CLS token is not rotated) before the softmax.  Each head's d channels
  hold d / 4 bands ``w_j = 10000^(-j / (d/4))``; the patch at grid row r and
  column c of a g x g grid sits at ``(r, c) * ref_grid / g`` (timm's
  ``ref_feat_shape``, the pretraining grid), and its d / 2 angles
  ``[r' w, c' w]`` are each repeated twice in place, giving cos and sin
  tables of ``[N, d]``.  ``rope(x) = x cos + rot(x) sin``, where ``rot``
  maps each interleaved pair ``(x_2i, x_2i+1)`` to ``(-x_2i+1, x_2i)``.
* MLP: SwiGLU with a LayerNorm over its hidden width (timm's ``scale_mlp``),
  ``fc2(norm(silu(fc1_g(x)) * fc1_x(x)))``.
* The stem keeps a learned absolute position embedding beside the RoPE.

No layer scale, no attention sub-norm; LayerNorm eps 1e-6 throughout; the
final LayerNorm is applied to every token, CLS first, as the ViT's is.  The
JAX package has no EVA: the port's parity is held against the benchmark's
plain reference, ``h100_bench/reference/families/eva.py``.

The rotary tables are computed at build in float64 and kept as one
non-persistent complex64 buffer ``rope`` (``cos + i sin`` of each pair's
angle, ``[T, d/2]``, the CLS row 1): it follows the module to its device and
is in no state dict.  The rotation of an interleaved pair is the complex
product ``(x_2i + i x_2i+1) e^(i angle)``, taken in float32 (float64 in a
float64 model) and rounded once to the model's type, as timm's rotation is
under autocast; the rotated q and k are written beside v into the
``[B, T, 3C]`` layout of the attention kernels, which take it as the ViT's
qkv (``vit.attend``: kernel 3 up to 256 tokens, kernel 6 beyond;
a 448 input has 1025).  On the card a head width the kernels do not take
raises.

In a bf16 model where no gradient is wanted (serving, the evaluator), the
SwiGLU's glue between fc1 and fc2 (SiLU times the gate, the hidden
LayerNorm, the pad) is ``kernels/swiglu_norm.py:swiglu_norm_fwd``, on the
card one kernel; otherwise the same composition in plain ops.

Spans (``utils/trace.py``): ``rope`` around the rotation and that write,
``swiglu`` around the whole MLP.  Training: ``drop_rate`` dropout after the
position embedding and ``remat='block'``, as in ``models/vit.py``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import swiglu_norm as _sn
from ..utils.trace import span
from .layers import Dense, Dropout, LayerNorm
from .vit import PatchEmbed, attend


@dataclasses.dataclass(frozen=True)
class EVAConfig:
    img_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_hidden: int = 2730  # int(embed_dim * 8 / 3)
    rope_ref_grid: int = 16  # timm's ref_feat_shape: the pretraining grid, 224 / 14
    drop_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    remat: str = "none"  # 'none' | 'attn' (same as 'none') | 'block'

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid ** 2


EVA_CONFIGS = {
    # CPU tests: 4 x 4 patches, two heads of 64
    "eva02_micro_patch14_56": EVAConfig(img_size=56, embed_dim=128, depth=2, num_heads=2,
                                        mlp_hidden=341, rope_ref_grid=4),
    "eva02_large_patch14_448": EVAConfig(img_size=448),
}


def rope_tables(grid: int, ref_grid: int, head_dim: int):
    """(cos, sin), each ``[grid * grid, head_dim]`` in float64, of the patches
    in row-major order."""
    bands = head_dim // 4
    freqs = 10000.0 ** (-torch.arange(bands, dtype=torch.float64) / bands)
    pos = torch.arange(grid, dtype=torch.float64) * (ref_grid / grid)
    rows, cols = torch.meshgrid(pos, pos, indexing="ij")
    angles = torch.cat([rows.reshape(-1, 1) * freqs, cols.reshape(-1, 1) * freqs], dim=-1)
    angles = angles.repeat_interleave(2, dim=-1)
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, rope: torch.Tensor, num_heads: int) -> torch.Tensor:
    """x ``[B, T, C]`` -> ``x cos + rot(x) sin`` in every head: each
    interleaved pair ``(x_2i, x_2i+1)`` times ``rope [T, d/2]`` (complex), in
    float32 (float64 for float64 x), returned in x's type."""
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    pairs = x.unflatten(-1, (num_heads, -1, 2)).to(wide).contiguous()
    turned = torch.view_as_complex(pairs) * rope[:, None]
    return torch.view_as_real(turned).flatten(-3).to(x.dtype)


class EVAAttention(nn.Module):
    """q / k / v projections -> RoPE on q and k -> attention kernel -> proj."""

    def __init__(self, dim: int, num_heads: int, dtype, device):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.k_proj = Dense(dim, dim, bias=False, dtype=dtype, device=device)
        self.v_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        with span("rope"):
            qkv = torch.cat([apply_rope(q, rope, self.num_heads),
                             apply_rope(k, rope, self.num_heads), v], dim=-1)
        return self.proj(attend(qkv, self.num_heads))


# A hidden width that is no multiple of ALIGN (EVA-02-L's 2730: bf16 rows of
# 5460 bytes) keeps cuBLAS off its 16-byte-aligned kernels: fc1 and fc2 ran
# ~3x slower on an H100 (1.47 / 1.64 ms against 0.53 / 0.48 at 2736).  On the
# card the products run at the width padded with zero weights: fc1's padded
# outputs are exactly 0, SiLU(0) * 0 = 0, the LayerNorm sees the true width
# only, and fc2's padded inputs meet zero weights.  The parameters keep the
# published width; the CPU's plain products take it as it is.
ALIGN = 8


def _widened(dense: Dense, x: torch.Tensor, rows: int = 0, cols: int = 0) -> torch.Tensor:
    """``dense(x)`` with its weight padded by ``rows`` zero outputs and
    ``cols`` zero inputs (x has the padded width)."""
    w = F.pad(dense.weight, (0, cols, 0, rows)).to(x.dtype)
    b = None if dense.bias is None else F.pad(dense.bias, (0, rows)).to(x.dtype)
    return F.linear(x, w, b)


class SwiGLU(nn.Module):
    """``fc2(norm(silu(fc1_g(x)) * fc1_x(x)))``, the LayerNorm over the hidden
    width; on the card the products at the width padded to a multiple of
    ``ALIGN``."""

    def __init__(self, dim: int, hidden: int, eps: float, dtype, device):
        super().__init__()
        self.fc1_g = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc1_x = Dense(dim, hidden, dtype=dtype, device=device)
        self.norm = LayerNorm(hidden, eps=eps, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swiglu"):
            return self.padded(x, -self.norm.weight.shape[0] % ALIGN if x.is_cuda else 0)

    def padded(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        """The MLP with its products ``pad`` hidden channels wider.  Between
        fc1 and fc2, SiLU times the gate, the hidden LayerNorm and the pad:
        in bf16 where no gradient is wanted, ``swiglu_norm_fwd`` (on the card
        its kernel), else the same composition, under autograd where a
        gradient is wanted."""
        norm = self.norm
        g = _widened(self.fc1_g, x, rows=pad)
        u = _widened(self.fc1_x, x, rows=pad)
        wants_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (g, u, norm.weight, norm.bias))
        kernel = g.dtype == torch.bfloat16 and not wants_grad
        glue = _sn.swiglu_norm_fwd if kernel else _sn.swiglu_norm_plain
        h = glue(g, u, norm.weight, norm.bias, norm.weight.shape[0], norm.eps)
        return _widened(self.fc2, h, cols=pad)


class EVABlock(nn.Module):
    def __init__(self, cfg: EVAConfig, dtype, device):
        super().__init__()
        dim, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.norm1 = LayerNorm(dim, eps=eps, device=device)
        self.attn = EVAAttention(dim, cfg.num_heads, dtype, device)
        self.norm2 = LayerNorm(dim, eps=eps, device=device)
        self.mlp = SwiGLU(dim, cfg.mlp_hidden, eps, dtype, device)

    def forward(self, x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class EVA(nn.Module):
    """NHWC images [B, H, W, 3] -> tokens [B, 1 + N, D], CLS first, after the
    final LayerNorm.  ``cls_token`` and ``pos_embed`` stay fp32 and are cast
    at use."""

    def __init__(self, config: EVAConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        cfg = config
        if cfg.remat not in ("none", "attn", "block"):
            raise ValueError(f"Unknown remat policy: {cfg.remat!r}")
        if cfg.embed_dim % cfg.num_heads or (cfg.embed_dim // cfg.num_heads) % 4:
            raise ValueError(f"embed_dim {cfg.embed_dim} over {cfg.num_heads} heads gives no "
                             "head width the 2D rotary embedding divides in four")
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
            self.add_module(name, EVABlock(cfg, dtype, device))
        self.norm = LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps, device=device)
        # one entry a pair (the tables repeat each angle twice), the CLS row
        # first: 1 leaves it as it is
        cos, sin = rope_tables(cfg.grid, cfg.rope_ref_grid, cfg.embed_dim // cfg.num_heads)
        rope = torch.complex(cos[:, 0::2], sin[:, 0::2])
        rope = torch.cat([torch.ones_like(rope[:1]), rope])
        self.register_buffer("rope", rope.to(device=device, dtype=torch.complex64),
                             persistent=False)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.patch_embed(images.to(self.dtype))
        b, n, d = x.shape
        if n + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{n} patches from a {tuple(images.shape[1:3])} input, but the position "
                f"embedding and rotary tables were built for {self.pos_embed.shape[1] - 1} "
                f"(img_size {self.config.img_size})")
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, d), x], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        x = self.drop(x, generator)
        remat = self.config.remat == "block" and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            if remat:
                # nothing in a block is stochastic, so no RNG state to replay
                x = checkpoint(block, x, self.rope, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, self.rope)
        return self.norm(x)
