"""Fused Graph Polynomial Fusion: CUDA kernel and plain version.

``gpf_fwd`` replaces the TPU kernel ``_gpf_kernel`` in
``ego_moment_cle_vit_tpu/ops/pallas/gpf.py`` (reached through
``fused_gpf_pallas``).  The kernel source and its design note are in
``csrc/gpf_fwd.cu``: one block per batch element keeps both ``[N, N]`` Grams
on chip and runs the polynomial, symmetrization and clamp there.  The output
is fp32 whatever the token dtype, as on the TPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.graph import gpf_fuse, token_similarity_graph
from . import _build

_SIGNATURES = {
    "gpf_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p],
        ctypes.c_int,
    )
}
MAX_TOKENS = 64


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
    return gpf_fuse(r_a, r_p, coeffs.float(), symmetric_enforce=symmetric_enforce)


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
        raise ValueError(f"kernel takes 1..{MAX_TOKENS} tokens, got N={tokens_a.shape[1]}")
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
    twice lets the kernel build one Gram.  Counts its launches in
    ``gpf_fwd.launches``.
    """
    if tokens_a.device.type == "cpu":
        return gpf_plain(tokens_a, tokens_p, coeffs, similarity, eps, symmetric_enforce)
    if tokens_a.device.type != "cuda":
        raise RuntimeError(f"gpf_fwd: unsupported device {tokens_a.device}")
    _check(tokens_a, tokens_p, coeffs, similarity)
    code = _build.dtype_code(tokens_a, "gpf_fwd")
    b, n, d = tokens_a.shape
    out = torch.empty((b, n, n), dtype=torch.float32, device=tokens_a.device)
    lib = _build.load("gpf_fwd", _SIGNATURES)
    rc = lib.gpf_fwd(
        tokens_a.data_ptr(), tokens_p.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
        b, n, d, coeffs.shape[0] - 1, coeffs.shape[1] - 1, int(similarity == "cosine"),
        float(eps), int(symmetric_enforce), code, _build.stream_ptr(tokens_a.device),
    )
    _build.check(lib, rc, "gpf_fwd")
    gpf_fwd.launches += 1
    return out


gpf_fwd.launches = 0
