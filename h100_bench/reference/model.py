"""The plain reference of the served and trained model, in float32.

A frozen, independent restatement of EGO-Moment-CLE-ViT's mathematics: a
Swin or ViT backbone, graph polynomial fusion of the two views' token Grams,
the graph-weighted moment head (token-subspace iSQRT-COV, paired vech,
Tensor-Sketch third order) and the 'add' or 'multiscale' classifier, with the
five-term loss.  Parameter and buffer names are the measured program's, so
one state dict loads into both.  It imports nothing of the program: every
product is a plain float32 ``torch`` operation (TF32 off, see
``fp32_products``).

``precision='fp8'`` is the control: every product that the configuration
runs in bfloat16 (the Dense layers, the patch convolution and the attention
products) takes its operands rounded to float8 e4m3, each tensor with its own
scale.  Products the configuration runs in float32 (the heads' Grams, the
iSQRT iteration, the sketch) stay float32.

The backbone runs on ``chunk`` images at a time, so the attention of
ViT-L/16 at 448 (785 tokens, 16 heads) fits at batch 64; training recomputes
each chunk for its backward (``RefModel.loss_and_grads``).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def fp32_products():
    """Full float32 matrix products and convolutions (no TF32) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor, back in
    float32.  Differentiable as the identity (straight-through)."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Dense(nn.Module):
    """y = x W^T + b; ``weight [out, in]``.  Served in the model's dtype."""

    served_in_model_dtype = True

    def __init__(self, d_in: int, d_out: int, precision: str, bias: bool = True):
        super().__init__()
        self.precision = precision
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        if self.precision == "fp8":
            return F.linear(fake_fp8(x), fake_fp8(self.weight), self.bias)
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """Non-overlapping patch convolution, NHWC in, ``[B, h, w, C]`` out."""

    served_in_model_dtype = True

    def __init__(self, d_out: int, patch: int, precision: str):
        super().__init__()
        self.precision, self.patch = precision, patch
        self.weight = nn.Parameter(torch.empty(d_out, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(d_out))

    def forward(self, images):
        x, w = images.permute(0, 3, 1, 2), self.weight
        if self.precision == "fp8":
            x, w = fake_fp8(x), fake_fp8(w)
        return F.conv2d(x, w, self.bias, stride=self.patch).permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


def dropout(x, p: float, training: bool, generator):
    """Inverted dropout; the keep mask from one ``torch.rand`` of x's shape."""
    if not training or p == 0.0:
        return x
    u = torch.rand(x.shape, dtype=torch.float32, device=x.device, generator=generator)
    return x * (u >= p).float() / (1.0 - p)


def dropout_mask(shape, p: float, generator, device):
    u = torch.rand(shape, dtype=torch.float32, device=device, generator=generator)
    return (u >= p).float() / (1.0 - p)


def attention(q, k, v, precision: str, bias=None):
    """softmax(q k^T + bias) v over the last two axes (q already scaled)."""
    if precision == "fp8":
        q, k, v = fake_fp8(q), fake_fp8(k), fake_fp8(v)
    logits = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    if precision == "fp8":
        probs = fake_fp8(probs)
    return torch.matmul(probs, v)


# ----------------------------------------------------------------------------
# Swin (Liu et al. 2021): shifted windows, relative position bias, patch merging
# ----------------------------------------------------------------------------


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


# ----------------------------------------------------------------------------
# ViT (Dosovitskiy et al. 2021): CLS token first, pre-norm blocks
# ----------------------------------------------------------------------------


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


class Backbone(nn.Module):
    """The program's nesting (``backbone.backbone.swin`` / ``.vit``)."""

    def __init__(self, arch: dict, precision: str):
        super().__init__()
        self.family = arch["family"]
        self.add_module(self.family, (Swin if self.family == "swin" else ViT)(arch, precision))

    @property
    def net(self):
        return getattr(self, self.family)

    def features(self, tokens):
        """Final tokens -> (patch tokens [B, N, D], global feature [B, D])."""
        if self.family == "vit":
            return tokens[:, 1:], tokens[:, 0]
        return tokens, tokens.mean(dim=1)


class DualStream(nn.Module):
    def __init__(self, arch, precision):
        super().__init__()
        self.backbone = Backbone(arch, precision)


# ----------------------------------------------------------------------------
# heads: GPF, moment head, classifiers
# ----------------------------------------------------------------------------


def gram(tokens, similarity: str, eps: float = 1e-6):
    if similarity == "cosine":
        tokens = tokens / tokens.norm(dim=-1, keepdim=True).clamp(min=eps)
    return torch.matmul(tokens, tokens.transpose(-1, -2))


def gpf_fuse(r_a, r_p, coeffs):
    """sym(sum_pq c_pq A_p(R_a) * A_q(R_p)) clamped at 0, A_0 = 1, A_1 = R,
    A_k = R clamp(R, 0)^(k-1)."""
    def powers(r, n):
        out, cur = [torch.ones_like(r)], torch.ones_like(r)
        for k in range(n):
            cur = cur * (r if k == 0 else r.clamp(min=0.0))
            out.append(cur)
        return out
    pa, pp = powers(r_a, coeffs.shape[0] - 1), powers(r_p, coeffs.shape[1] - 1)
    fused = sum(coeffs[p, q] * pa[p] * pp[q]
                for p in range(coeffs.shape[0]) for q in range(coeffs.shape[1]))
    return (0.5 * (fused + fused.transpose(-1, -2))).clamp(min=0.0)


class GPF(nn.Module):
    def __init__(self, p: int, q: int, similarity: str):
        super().__init__()
        self.similarity = similarity
        self.alpha_coeffs = nn.Parameter(torch.empty(p + 1, q + 1))

    def forward(self, tokens_a, tokens_p):
        return gpf_fuse(gram(tokens_a, self.similarity), gram(tokens_p, self.similarity),
                        F.softplus(self.alpha_coeffs))


def paired_vech(m):
    """The upper triangle in the paired order: row i beside row D-1-i reversed."""
    d = m.shape[-1]
    flat = F.pad(m.reshape(*m.shape[:-2], d * d), (0, d)).reshape(*m.shape[:-2], d, d + 1)
    rows = torch.arange(d, device=m.device)[:, None]
    cols = torch.arange(d + 1, device=m.device)[None, :]
    u = torch.where(cols < d - rows, flat, torch.zeros((), device=m.device))
    packed = u[..., : d // 2, :] + torch.flip(u[..., d // 2:, :], dims=(-2, -1))
    return packed.reshape(*m.shape[:-2], d * (d + 1) // 2)


def isqrt_subspace(a, b, iterations: int, eps: float):
    """(A^T B)^-1/2 for N < D by the coupled Newton–Schulz iteration in the
    N-dimensional token subspace (A = centred tokens, B = W A)."""
    n = a.shape[-2]
    trace = torch.sum(a * b, dim=(-2, -1))[..., None, None]
    bh = b / (trace + eps)
    s = torch.matmul(bh, a.transpose(-1, -2))
    eye = torch.eye(n, device=a.device)
    a_k, g = 1.0, torch.zeros_like(s)
    for _ in range(iterations):
        sg = torch.matmul(s, g)
        h = (a_k * a_k) * eye + torch.matmul(s, 2.0 * a_k * g + torch.matmul(g, sg))
        g = 1.5 * g - 0.5 * (a_k * h + torch.matmul(g, torch.matmul(s, h)))
        a_k = 1.5 * a_k
    out = torch.matmul(a.transpose(-1, -2), torch.matmul(g, bh))
    out = out + a_k * torch.eye(a.shape[-1], device=a.device)
    return out / torch.sqrt(trace + eps)


def sketch_dim(d: int, sketch: int, cap: int = 4) -> int:
    return -(-min(sketch, cap * d) // 128) * 128


class MomentHead(nn.Module):
    HEAD_EPS = 1e-6

    def __init__(self, d: int, d_out: int, iterations: int, sketch: int, p_drop: float,
                 precision: str, eps: float = 1e-5):
        super().__init__()
        self.iterations, self.eps, self.p_drop = iterations, eps, p_drop
        half = d_out // 2
        self.second_proj = Dense(d * (d + 1) // 2, half, precision)
        self.second_norm = LayerNorm(half, self.HEAD_EPS)
        k = sketch_dim(d, sketch)
        self.register_buffer("sketch_matrices", torch.empty(3, d, k))
        self.third_proj = Dense(k, d_out - half, precision)
        self.third_norm = LayerNorm(d_out - half, self.HEAD_EPS)

    def forward(self, tokens, graph, generator=None):
        n, d = tokens.shape[-2:]
        if n >= d:
            raise NotImplementedError("the dense moment route (N >= D) has no reference here")
        eps = self.eps
        deg = graph.sum(dim=-1)
        inv = torch.rsqrt(deg.clamp(min=eps))
        w = graph * inv[..., :, None] * inv[..., None, :]
        trace_w = torch.diagonal(w, dim1=-2, dim2=-1).sum(-1)[..., None]
        rows = w.sum(dim=-1)
        mu = torch.einsum("bnd,bn->bd", tokens, rows) / (trace_w + eps)
        centered = tokens - mu[:, None]
        m2 = isqrt_subspace(centered, torch.matmul(w, centered), self.iterations, eps)
        x = F.gelu(self.second_norm(self.second_proj(paired_vech(m2))))
        x = dropout(x, self.p_drop, self.training, generator)
        pooled = torch.einsum("bnd,bn->bd", centered, rows) / (trace_w + eps)
        s = [torch.matmul(pooled, self.sketch_matrices[i]) for i in range(3)]
        f = torch.fft.rfft(s[0]) * torch.fft.rfft(s[1]) * torch.fft.rfft(s[2])
        third = torch.fft.irfft(f, n=self.sketch_matrices.shape[-1])
        y = F.gelu(self.third_norm(self.third_proj(third)))
        y = dropout(y, self.p_drop, self.training, generator)
        return torch.cat([x, y], dim=-1)


class AddClassifier(nn.Module):
    """'add' fusion (projected where the widths differ), then fc1 -> norm ->
    GELU -> drop -> fc2 -> norm -> GELU -> drop -> fc_out."""

    def __init__(self, d_cls, d_moment, classes, p_drop, precision):
        super().__init__()
        self.p_drop = p_drop
        self.project = d_cls != d_moment
        if self.project:
            self.cls_proj = Dense(d_cls, d_moment, precision)
            self.moment_proj = Dense(d_moment, d_moment, precision)
        hidden = max(d_moment // 2, 256)
        self.fc1 = Dense(d_moment, hidden, precision)
        self.norm1 = LayerNorm(hidden, MomentHead.HEAD_EPS)
        self.fc2 = Dense(hidden, hidden // 2, precision)
        self.norm2 = LayerNorm(hidden // 2, MomentHead.HEAD_EPS)
        self.fc_out = Dense(hidden // 2, classes, precision)

    def forward(self, cls, moments, generator=None):
        x = self.cls_proj(cls) + self.moment_proj(moments) if self.project else cls + moments
        x = dropout(F.gelu(self.norm1(self.fc1(x))), self.p_drop, self.training, generator)
        x = dropout(F.gelu(self.norm2(self.fc2(x))), self.p_drop, self.training, generator)
        return self.fc_out(x)


class ScaleAttention(nn.Module):
    def __init__(self, dim, precision):
        super().__init__()
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(dim, dim, precision))

    def forward(self, x):
        logits = torch.matmul(self.query(x) / math.sqrt(x.shape[-1]), self.key(x).transpose(-1, -2))
        return self.out(torch.matmul(torch.softmax(logits, dim=-1), self.value(x)))


class MultiScaleClassifier(nn.Module):
    """Three scales i: [cls_proj_i(cls), moment_proj_i(m)] -> scale_fc_i ->
    norm -> GELU -> drop -> scale_out_i; attention over the three logits, mean."""

    def __init__(self, d_cls, d_moment, classes, p_drop, precision, scales: int = 3):
        super().__init__()
        self.p_drop, self.scales = p_drop, scales
        for i in range(scales):
            c, m = d_cls // 2 ** i, d_moment // 2 ** i
            setattr(self, f"cls_proj_{i}", Dense(d_cls, c, precision))
            setattr(self, f"moment_proj_{i}", Dense(d_moment, m, precision))
            setattr(self, f"scale_fc_{i}", Dense(c + m, (c + m) // 2, precision))
            setattr(self, f"scale_norm_{i}", LayerNorm((c + m) // 2, MomentHead.HEAD_EPS))
            setattr(self, f"scale_out_{i}", Dense((c + m) // 2, classes, precision))
        self.scale_attention = ScaleAttention(classes, precision)

    def forward(self, cls, moments, generator=None):
        logits = []
        for i in range(self.scales):
            x = torch.cat([getattr(self, f"cls_proj_{i}")(cls),
                           getattr(self, f"moment_proj_{i}")(moments)], dim=-1)
            x = F.gelu(getattr(self, f"scale_norm_{i}")(getattr(self, f"scale_fc_{i}")(x)))
            logits.append(getattr(self, f"scale_out_{i}")(
                dropout(x, self.p_drop, self.training, generator)))
        return self.scale_attention(torch.stack(logits, dim=1)).mean(dim=1)


# ----------------------------------------------------------------------------
# the model and its loss
# ----------------------------------------------------------------------------


def cross_entropy(logits, labels):
    return -torch.gather(F.log_softmax(logits, dim=-1), 1, labels[:, None].long())[:, 0].mean()


def roll_triplet(anchor, positive, margin):
    """Squared distances of unit features; the negative of i is anchor i-1."""
    a = anchor / anchor.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    p = positive / positive.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    n = torch.roll(a, 1, dims=0)
    pos, neg = ((a - p) ** 2).sum(-1), ((a - n) ** 2).sum(-1)
    return (pos - neg + margin).clamp(min=0.0).mean()


def alignment_mse(graph_means, labels):
    same = (labels[:, None] == labels[None, :]).float()
    return torch.mean((torch.sigmoid(torch.outer(graph_means, graph_means)) - same) ** 2)


class RefModel(nn.Module):
    """The whole model.  ``spec`` is a configuration file's content."""

    def __init__(self, spec: dict, precision: str = "fp32"):
        super().__init__()
        arch, mcfg = spec["architecture"], spec["port_config"]["model"]
        tcfg = spec["port_config"].get("training", {})
        loss = tcfg.get("loss", {})
        gpf, moment = mcfg.get("gpf", {}), mcfg.get("moment", {})
        classifier = mcfg.get("classifier", {})
        self.chunk = spec["reference_chunk"]
        self.lambda_triplet = loss.get("lambda_triplet", 1.0)
        self.lambda_align = loss.get("lambda_align", 0.1)
        self.margin = loss.get("margin", 0.3)
        self.p_drop = classifier.get("dropout", 0.1)
        d = arch["num_features"]
        d_out = moment.get("d_out", 1024)
        classes = spec["num_classes"]
        self.backbone = DualStream(arch, precision)
        self.gpf = GPF(gpf.get("degree_p", 2), gpf.get("degree_q", 2),
                       gpf.get("similarity", "cosine"))
        self.moment_head = MomentHead(d, d_out, moment.get("isqrt_iterations", 5),
                                      moment.get("sketch_dim", 4096), self.p_drop, precision)
        if classifier.get("type", "standard") == "multiscale":
            self.classifier = MultiScaleClassifier(d, d_out, classes, self.p_drop, precision)
        elif classifier.get("fusion_type", "concat") == "add":
            self.classifier = AddClassifier(d, d_out, classes, self.p_drop, precision)
        else:
            raise NotImplementedError("only the 'add' and 'multiscale' classifiers have a "
                                      "reference here")
        self.cls_only_classifier = Dense(d, classes, precision)

    @property
    def net(self):
        return self.backbone.backbone.net

    # -- the backbone in chunks ------------------------------------------------

    def tokens(self, images, mask=None):
        """Final backbone tokens of ``images``, ``chunk`` images at a time;
        ``mask``: the dropout keep mask (already scaled) for the whole batch."""
        out = []
        for lo in range(0, images.shape[0], self.chunk):
            x = self.net.stem(images[lo:lo + self.chunk])
            if mask is not None:
                x = x * mask[lo:lo + self.chunk]
            out.append(self.net.body(x))
        return torch.cat(out)

    def heads(self, tokens_a, tokens_p, global_a, generator=None):
        graph = self.gpf(tokens_a, tokens_p)
        moments = self.moment_head(tokens_a, graph, generator)
        return self.classifier(global_a, moments, generator), graph

    @torch.no_grad()
    def infer(self, images):
        """Serving: one view, R_p := R_a -> logits."""
        self.eval()
        patch, glob = self.backbone.backbone.features(self.tokens(images))
        return self.heads(patch, patch, glob)[0]

    def loss_terms(self, feats_a, feats_p, labels, generator):
        (ta, ga), (tp, gp) = feats_a, feats_p
        logits, graph = self.heads(ta, tp, ga, generator)
        terms = {"loss_main_ce": cross_entropy(logits, labels),
                 "loss_anchor_ce": cross_entropy(self.cls_only_classifier(ga), labels),
                 "loss_positive_ce": cross_entropy(self.cls_only_classifier(gp), labels)}
        if self.lambda_triplet > 0:
            terms["loss_triplet"] = self.lambda_triplet * roll_triplet(ga, gp, self.margin)
        if self.lambda_align > 0:
            terms["loss_align"] = self.lambda_align * alignment_mse(graph.mean(dim=(1, 2)),
                                                                    labels)
        return terms

    def loss_and_grads(self, anchor, positive, labels, generator):
        """The training forward and backward on [anchor; positive].  The
        backbone runs without a graph first; the heads and the loss then take
        its tokens as leaves, and each chunk is run again with a graph and
        given its tokens' gradient.  Returns the loss (a float tensor)."""
        self.train()
        self.zero_grad(set_to_none=True)
        images = torch.cat([anchor, positive])
        b = anchor.shape[0]
        with torch.no_grad():
            stem_shape = (images.shape[0],) + tuple(self.net.stem(images[:1]).shape[1:])
        mask = dropout_mask(stem_shape, self.p_drop, generator, images.device)
        with torch.no_grad():
            toks = self.tokens(images, mask)
        toks.requires_grad_(True)
        bb = self.backbone.backbone
        terms = self.loss_terms(bb.features(toks[:b]), bb.features(toks[b:]), labels, generator)
        loss = sum(terms.values())
        loss.backward()
        dtoks = toks.grad
        for lo in range(0, images.shape[0], self.chunk):
            x = self.net.stem(images[lo:lo + self.chunk]) * mask[lo:lo + self.chunk]
            self.net.body(x).backward(dtoks[lo:lo + self.chunk])
        return loss.detach()


def served_dtypes(model: nn.Module, model_dtype: torch.dtype) -> dict:
    """{state-dict name: the dtype the program serves it in}: Dense and
    convolution leaves in the model's dtype, every other leaf in float32."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            out[full] = model_dtype if getattr(mod, "served_in_model_dtype", False) else torch.float32
    return out
