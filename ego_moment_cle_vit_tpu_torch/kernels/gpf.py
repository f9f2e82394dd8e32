"""Fused Graph Polynomial Fusion: CUDA kernel and plain version.

``gpf_fwd`` replaces the TPU kernel ``_gpf_kernel`` in
``ego_moment_cle_vit_tpu/ops/pallas/gpf.py`` (reached through
``fused_gpf_pallas``).  The kernel source and its design note are in
``csrc/gpf_fwd.cu``: each block keeps its output tile of both Grams on chip
and runs the polynomial, symmetrization and clamp there, so a Swin's 49
tokens and a ViT's 196 take the same kernel.  For bf16 tokens
(``csrc/gpf_fwd_sm90.cuh``) blocks own only the tiles of the upper triangle,
write each tile and its mirror, and build the Grams on wgmma from a TMA ring
(launch geometry :func:`fwd_geometry`, block order :func:`fwd_tile_pairs`);
fp32 tokens take one block per 64 x 64 tile of the whole square on the CUDA
cores.  The output is fp32 whatever the token dtype, as on the TPU.

``gpf_bwd`` replaces ``_gpf_bwd_kernel`` of the same file
(``csrc/gpf_bwd.cu``): the analytic VJP in two tiled kernels, token gradients
for both views and per-batch coefficient gradients.  The second forms dX = W X
from the first's [N, N] factor W: for bf16 tokens on the tensor cores through
wgmma, from W split in two bf16 terms (``csrc/gpf_bwd_sm90.cuh``, its launch
geometry :func:`bwd_geometry`), for fp32 tokens on the CUDA cores
(``csrc/gpf_bwd_fp32.cuh``).  ``gpf`` is the
differentiable entry point the model calls, a ``torch.autograd.Function``
that saves ``(tokens_a, tokens_p, coeffs)``.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.graph import gpf_fuse, token_similarity_graph
from ..utils.trace import span
from . import _build

_SIGNATURES = {
    "gpf_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    )
}
_BWD_SIGNATURES = {
    "gpf_bwd": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int,
    )
}
TILE = 64  # output rows and columns per block
# The tiled kernels have no token limit of their own; this is the largest
# count they are held to on the card (chip_smoke.py: Swin-Large at 1280, N =
# 1600).  The TPU kernel's envelope (``fused_gpf_fits``: (2*N*D + 6*N*N) * 4
# bytes < 12 MiB) ends earlier: it admits a ViT at 224 (N = 196, D up to
# 1024) and not one at 448 (N = 784: its six [N, N] work tiles alone pass the
# limit), where the TPU package computes the same function in XLA.
MAX_TOKENS = 1600
MAX_DEGREE = 3  # the backward kernel's compiled polynomial degree limit
# The bf16 dX kernel's block (csrc/gemm_sm90.cuh): a [128 rows][256 features]
# tile of dX, the contraction over tokens in stages of 64, three stages in
# flight, each W_hi and W_lo [128][64] and a token tile [64][256] in shared
# memory, behind 1024 bytes of alignment slack and a full and an empty
# barrier a stage.
BWD_ROWS, BWD_COLS, BWD_K, BWD_STAGES = 128, 256, 64, 3
SMEM_LIMIT = 232448  # what a block may use on an H100
# The bf16 forward (csrc/gpf_fwd_sm90.cuh): square output tiles of 64 tokens
# up to FWD_WIDE_FROM tokens, of 128 past it (one or two consumer warpgroups
# and a producer warp), the features in stages of 64, three stages in flight,
# each the row and column token tiles of every token set.
FWD_K, FWD_STAGES, FWD_WIDE_FROM = 64, 3, 257


def fwd_geometry(tokens: int, same: bool) -> dict:
    """How the bf16 forward (``csrc/gpf_fwd_sm90.cuh``) cuts one batch
    element of ``tokens`` tokens, with one token set
    (``same``: anchor and positive the same tensor) or two.

    ``tiles`` x ``tiles`` output tiles of ``tile`` tokens square; a block
    owns one tile of the upper triangle (``pairs`` of them, in the order of
    :func:`fwd_tile_pairs`) and also writes its mirror.  ``smem`` is what a
    block asks for (the C side's ``Shape::bytes``), ``epilogue_bytes`` what
    the epilogue's fp32 tiles take of it, ``blocks_per_sm`` what registers
    and shared memory leave room for.
    """
    wg = 2 if tokens >= FWD_WIDE_FROM else 1
    tile = 64 * wg
    sets = 1 if same else 2
    tiles = -(-tokens // tile)
    stage = 2 * sets * tile * FWD_K * 2
    return {"tile": tile, "tiles": tiles, "pairs": tiles * (tiles + 1) // 2,
            "stages": FWD_STAGES, "smem": 1024 + FWD_STAGES * stage + 16 * FWD_STAGES,
            "epilogue_bytes": sets * tile * (tile + 1) * 4,
            "blocks_per_sm": (3 if same else 2) if wg == 1 else (2 if same else 1)}


def fwd_tile_pairs(tiles: int) -> list[tuple[int, int]]:
    """(row tile, column tile) of each block of the bf16 forward, in block
    order: the upper triangle row by row, as the kernel walks it."""
    return [(it, jt) for it in range(tiles) for jt in range(it, tiles)]


def bwd_geometry(tokens: int, features: int) -> dict:
    """How the bf16 dX kernel (``csrc/gpf_bwd_sm90.cuh``) cuts dX = W X of
    one (batch element, token set) with ``tokens`` tokens of ``features``.

    ``row_blocks`` x ``col_blocks`` blocks of ``rows`` x ``cols`` cover dX;
    each walks the ``k_tiles`` tiles of ``k`` tokens.  The w kernel writes
    W_hi and W_lo with rows ``pitch`` elements apart, the tokens rounded up to
    a multiple of 8, so that the W tensor maps' row stride is a multiple of 16
    bytes as TMA requires; ``tma_tokens`` says whether the token rows keep
    that rule too (else the producer warp stages them by hand).  ``smem`` is
    the shared memory a block asks for, the C side's ``Layout<2>::bytes``.
    """
    stage = 2 * BWD_ROWS * BWD_K * 2 + BWD_K * BWD_COLS * 2
    return {"rows": BWD_ROWS, "row_blocks": -(-tokens // BWD_ROWS), "cols": BWD_COLS,
            "col_blocks": -(-features // BWD_COLS), "k": BWD_K, "k_tiles": -(-tokens // BWD_K),
            "pitch": -(-tokens // 8) * 8, "tma_tokens": features % 8 == 0,
            "stages": BWD_STAGES, "smem": 1024 + BWD_STAGES * stage + 16 * BWD_STAGES}


def gpf_plain(
    tokens_a: torch.Tensor,
    tokens_p: torch.Tensor,
    coeffs: torch.Tensor,
    similarity: str = "cosine",
    eps: float = 1e-6,
    symmetric_enforce: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: two fp32 Grams, then ``gpf_fuse``."""
    r_a = token_similarity_graph(tokens_a, similarity, eps)
    r_p = token_similarity_graph(tokens_p, similarity, eps)
    return gpf_fuse(r_a, r_p, coeffs.to(r_a.dtype), symmetric_enforce=symmetric_enforce)


def gpf_bwd_plain(
    tokens_a: torch.Tensor,
    tokens_p: torch.Tensor,
    coeffs: torch.Tensor,
    g: torch.Tensor,
    similarity: str = "cosine",
    eps: float = 1e-6,
    symmetric_enforce: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: the analytic VJP.

    tokens [B, N, D] x2, coeffs [P+1, Q+1], g [B, N, N] -> (dta, dtp in the
    token dtype, dc [B, P+1, Q+1] fp32, to be summed over the batch).  fp32
    inside (fp64 for fp64 tokens).  Given one tensor twice, the two token
    gradients are still returned apart; their sum is that tensor's gradient.
    """
    wide = torch.float64 if tokens_a.dtype == torch.float64 else torch.float32
    a, p_ = tokens_a.to(wide), tokens_p.to(wide)
    g = g.to(wide)
    c = coeffs.to(wide)
    if similarity == "cosine":
        sa = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
        sp = torch.sqrt(torch.sum(p_ * p_, dim=-1, keepdim=True))
        ma, mp = sa.clamp(min=eps), sp.clamp(min=eps)
        ah, ph = a / ma, p_ / mp
    elif similarity == "dot":
        ah, ph = a, p_
    else:
        raise ValueError(f"Unknown similarity function: {similarity}")
    r_a = torch.matmul(ah, ah.transpose(-1, -2))
    r_p = torch.matmul(ph, ph.transpose(-1, -2))

    def powers(r, degree):
        # A_k = R clamp(R)^(k-1), A'_k = k clamp(R)^(k-1); A_0 = 1
        rc = r.clamp(min=0.0)
        vals, grads = [torch.ones_like(r)], [torch.zeros_like(r)]
        rc_pow = torch.ones_like(r)
        for k in range(1, degree + 1):
            vals.append(r * rc_pow)
            grads.append(k * rc_pow)
            rc_pow = rc_pow * rc
        return vals, grads

    a_vals, a_grads = powers(r_a, c.shape[0] - 1)
    b_vals, b_grads = powers(r_p, c.shape[1] - 1)
    fused = torch.zeros_like(r_a)
    for p in range(c.shape[0]):
        for q in range(c.shape[1]):
            fused = fused + c[p, q] * (a_vals[p] * b_vals[q])
    if symmetric_enforce:
        fused = 0.5 * (fused + fused.transpose(-1, -2))
    df = g * (fused > 0.0).to(wide)
    if symmetric_enforce:
        df = 0.5 * (df + df.transpose(-1, -2))

    dra = torch.zeros_like(r_a)
    drp = torch.zeros_like(r_p)
    dc = torch.zeros(a.shape[0], *c.shape, dtype=wide, device=a.device)
    for p in range(c.shape[0]):
        for q in range(c.shape[1]):
            term = df * c[p, q]
            dra = dra + term * (a_grads[p] * b_vals[q])
            drp = drp + term * (a_vals[p] * b_grads[q])
            dc[:, p, q] = torch.sum(df * (a_vals[p] * b_vals[q]), dim=(-2, -1))
    # Gram backward: R = X X^T  =>  dX = (dR + dR^T) X
    dah = torch.matmul(dra + dra.transpose(-1, -2), ah)
    dph = torch.matmul(drp + drp.transpose(-1, -2), ph)
    if similarity == "cosine":
        # xh = x / max(|x|, eps): dx = (dxh - [|x| > eps] xh (xh . dxh)) / max(|x|, eps)
        da = (dah - (sa > eps).to(wide) * ah * torch.sum(ah * dah, dim=-1, keepdim=True)) / ma
        dp = (dph - (sp > eps).to(wide) * ph * torch.sum(ph * dph, dim=-1, keepdim=True)) / mp
    else:
        da, dp = dah, dph
    dc_dtype = torch.float64 if wide == torch.float64 else torch.float32
    return da.to(tokens_a.dtype), dp.to(tokens_p.dtype), dc.to(dc_dtype)


def gpf_error_scale(
    tokens_a: torch.Tensor,
    tokens_p: torch.Tensor,
    coeffs: torch.Tensor,
    similarity: str = "cosine",
    eps: float = 1e-6,
    symmetric_enforce: bool = True,
) -> torch.Tensor:
    """[B, N, N] per-entry scale for judging a rounding difference of the GPF.

    The polynomial's terms summed in absolute value, with every Gram entry
    widened by 2^-10 of its Cauchy-Schwarz bound sqrt(R_ii R_jj): a sum of D
    fp32 products is off by far less than that, and an entry whose Gram
    product cancels to ~0 keeps room for it.  Two fp32 computations of the
    same entry differ by ~1e-5 of this scale; a wrong entry differs by about
    its own size, which is most of it.  Unlike a tolerance scaled by the
    largest entry (a dot Gram's diagonal, ~D^4), it holds every entry.
    """

    def widen(r):
        d = r.diagonal(dim1=-2, dim2=-1).clamp(min=0.0).sqrt()
        slack = 2.0**-10 * d[..., :, None] * d[..., None, :]
        return r.abs() + slack, r.clamp(min=0.0) + slack

    ra_first, ra_next = widen(token_similarity_graph(tokens_a, similarity, eps))
    rp_first, rp_next = widen(token_similarity_graph(tokens_p, similarity, eps))
    coeffs = coeffs.float()
    scale = torch.zeros_like(ra_first)
    ra_pow = torch.ones_like(ra_first)
    for p in range(coeffs.shape[0]):
        rp_pow = torch.ones_like(rp_first)
        for q in range(coeffs.shape[1]):
            scale = scale + coeffs[p, q].abs() * (ra_pow * rp_pow)
            rp_pow = rp_pow * (rp_first if q == 0 else rp_next)
        ra_pow = ra_pow * (ra_first if p == 0 else ra_next)
    if symmetric_enforce:
        scale = 0.5 * (scale + scale.transpose(-1, -2))
    return scale


def _check(tokens_a, tokens_p, coeffs, similarity):
    if similarity not in ("cosine", "dot"):
        raise ValueError(f"Unknown similarity function: {similarity}")
    if tokens_a.dim() != 3 or tokens_a.shape != tokens_p.shape:
        raise ValueError(f"tokens must both be [B, N, D], got {tuple(tokens_a.shape)} and "
                         f"{tuple(tokens_p.shape)}")
    if tokens_a.dtype != tokens_p.dtype:
        raise TypeError(f"token dtypes differ: {tokens_a.dtype} vs {tokens_p.dtype}")
    if not 1 <= tokens_a.shape[1] <= MAX_TOKENS:
        raise ValueError(
            f"kernel takes 1..{MAX_TOKENS} tokens (the largest count it is held to on the "
            f"card), got N={tokens_a.shape[1]}")
    if coeffs.dim() != 2 or coeffs.dtype != torch.float32:
        raise ValueError(f"coeffs must be float32 [P+1, Q+1], got {coeffs.dtype} "
                         f"{tuple(coeffs.shape)}")
    for name, t in (("tokens_a", tokens_a), ("tokens_p", tokens_p), ("coeffs", coeffs)):
        if t.device != tokens_a.device:
            raise ValueError(f"{name} is on {t.device}, tokens_a on {tokens_a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gpf_fwd(
    tokens_a: torch.Tensor,
    tokens_p: torch.Tensor,
    coeffs: torch.Tensor,
    similarity: str = "cosine",
    eps: float = 1e-6,
    symmetric_enforce: bool = True,
) -> torch.Tensor:
    """tokens [B, N, D] x2 + nonnegative coeffs [P+1, Q+1] -> [B, N, N] fp32.

    CPU tensors take :func:`gpf_plain`; CUDA tensors launch the kernel (after
    dtype, shape and contiguity checks) or raise.  Passing the same tensor
    twice lets the kernel build one Gram (the C side tells one tensor from
    two by their pointers, and so does the geometry here).  Counts its
    launches in
    ``gpf_fwd.launches``.
    """
    if tokens_a.device.type == "cpu":
        return gpf_plain(tokens_a, tokens_p, coeffs, similarity, eps, symmetric_enforce)
    if tokens_a.device.type != "cuda":
        raise RuntimeError(f"gpf_fwd: unsupported device {tokens_a.device}")
    _check(tokens_a, tokens_p, coeffs, similarity)
    code = _build.dtype_code(tokens_a, "gpf_fwd")
    b, n, d = tokens_a.shape
    geo = fwd_geometry(n, tokens_a.data_ptr() == tokens_p.data_ptr())
    out = torch.empty((b, n, n), dtype=torch.float32, device=tokens_a.device)
    lib = _build.load("gpf_fwd", _SIGNATURES)
    with span("kernel.gpf_fwd"):
        rc = lib.gpf_fwd(
            tokens_a.data_ptr(), tokens_p.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
            b, n, d, coeffs.shape[0] - 1, coeffs.shape[1] - 1, int(similarity == "cosine"),
            float(eps), int(symmetric_enforce), code, geo["tile"], geo["stages"], geo["smem"],
            _build.stream_ptr(tokens_a.device),
        )
    _build.check(lib, rc, "gpf_fwd")
    gpf_fwd.launches += 1
    return out


gpf_fwd.launches = 0


def gpf_bwd(
    tokens_a: torch.Tensor,
    tokens_p: torch.Tensor,
    coeffs: torch.Tensor,
    g: torch.Tensor,
    similarity: str = "cosine",
    eps: float = 1e-6,
    symmetric_enforce: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """VJP of :func:`gpf_fwd`: (dta, dtp [B, N, D], dc [B, P+1, Q+1] fp32).

    CPU tensors take :func:`gpf_bwd_plain`; CUDA tensors launch the kernel
    (after the forward's checks, on ``g`` too) or raise.  ``dc`` is per batch
    element; the caller sums it.  Counts its launches in ``gpf_bwd.launches``.
    """
    if tokens_a.device.type == "cpu":
        return gpf_bwd_plain(tokens_a, tokens_p, coeffs, g, similarity, eps, symmetric_enforce)
    if tokens_a.device.type != "cuda":
        raise RuntimeError(f"gpf_bwd: unsupported device {tokens_a.device}")
    _check(tokens_a, tokens_p, coeffs, similarity)
    b, n, d = tokens_a.shape
    if max(coeffs.shape) - 1 > MAX_DEGREE:
        raise ValueError(f"the backward kernel takes degrees up to {MAX_DEGREE}, got coeffs "
                         f"{tuple(coeffs.shape)}")
    if (g.device != tokens_a.device or g.dtype != torch.float32 or tuple(g.shape) != (b, n, n)
            or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous float32 [{b}, {n}, {n}] on {tokens_a.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    code = _build.dtype_code(tokens_a, "gpf_bwd")
    dta = torch.empty_like(tokens_a)
    dtp = torch.empty_like(tokens_p)
    dc = torch.empty((b, *coeffs.shape), dtype=torch.float32, device=tokens_a.device)
    if tokens_a.dtype == torch.bfloat16:
        geo = bwd_geometry(n, d)
        pitch, stages, smem = geo["pitch"], geo["stages"], geo["smem"]
    else:
        pitch, stages, smem = n, 0, 0
    # W (fp32 [B,2,N,N], or bf16 W_hi and W_lo [B,2,N,pitch]: 4 bytes an entry
    # either way), row-reduction partials [B,2,tiles,N], norms and gates
    # [B,4,N], coefficient partials [B,tiles^2,16]: see csrc/gpf_bwd.cu
    tiles = -(-n // TILE)
    scratch = torch.empty(b * (2 * n * pitch + 2 * tiles * n + 4 * n + 16 * tiles * tiles),
                          dtype=torch.float32, device=tokens_a.device)
    lib = _build.load("gpf_bwd", _BWD_SIGNATURES)
    with span("kernel.gpf_bwd"):
        rc = lib.gpf_bwd(
            tokens_a.data_ptr(), tokens_p.data_ptr(), coeffs.data_ptr(), g.data_ptr(),
            dta.data_ptr(), dtp.data_ptr(), dc.data_ptr(), scratch.data_ptr(),
            b, n, d, coeffs.shape[0] - 1, coeffs.shape[1] - 1, int(similarity == "cosine"),
            float(eps), int(symmetric_enforce), code, pitch, stages, smem,
            _build.stream_ptr(tokens_a.device),
        )
    _build.check(lib, rc, "gpf_bwd")
    gpf_bwd.launches += 1
    return dta, dtp, dc


gpf_bwd.launches = 0


class GPFFunction(torch.autograd.Function):
    """Fused GPF under autograd: forward and backward each go through their
    wrapper (kernel on CUDA tensors, plain version on CPU tensors).  Saves
    ``(tokens_a, tokens_p, coeffs)``.  Given one tensor as both token sets,
    autograd adds the two token gradients returned here."""

    @staticmethod
    def forward(ctx, tokens_a, tokens_p, coeffs, similarity, eps, symmetric_enforce):
        ctx.save_for_backward(tokens_a, tokens_p, coeffs)
        ctx.options = (similarity, eps, symmetric_enforce)
        return gpf_fwd(tokens_a, tokens_p, coeffs, similarity, eps, symmetric_enforce)

    @staticmethod
    def backward(ctx, g):
        tokens_a, tokens_p, coeffs = ctx.saved_tensors
        dta, dtp, dc = gpf_bwd(tokens_a, tokens_p, coeffs, g.contiguous(), *ctx.options)
        return dta, dtp, torch.sum(dc, dim=0).to(coeffs.dtype), None, None, None


def gpf(
    tokens_a: torch.Tensor,
    tokens_p: torch.Tensor,
    coeffs: torch.Tensor,
    similarity: str = "cosine",
    eps: float = 1e-6,
    symmetric_enforce: bool = True,
) -> torch.Tensor:
    """Differentiable fused GPF (to both token sets and the coefficients).
    Where no gradient can be asked for, the forward wrapper is called directly."""
    if not (torch.is_grad_enabled() and (tokens_a.requires_grad or tokens_p.requires_grad
                                         or coeffs.requires_grad)):
        return gpf_fwd(tokens_a, tokens_p, coeffs, similarity, eps, symmetric_enforce)
    return GPFFunction.apply(tokens_a, tokens_p, coeffs, similarity, eps, symmetric_enforce)
