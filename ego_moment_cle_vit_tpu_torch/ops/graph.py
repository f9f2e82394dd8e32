"""Token-similarity graphs and Graph Polynomial Fusion math.

Counterpart of ``ego_moment_cle_vit_tpu/ops/graph.py:23-142``.  Batch-first
``[B, N, D]`` tokens, ``[B, N, N]`` graphs; the Grams accumulate in fp32.
"""

from __future__ import annotations

import torch


def _l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / max(||x||, eps)`` over the last dim (the JAX package's floor)."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def token_similarity_graph(
    tokens: torch.Tensor, similarity: str = "cosine", eps: float = 1e-6
) -> torch.Tensor:
    """[B, N, D] -> [B, N, N] fp32 Gram ('cosine' | 'dot')."""
    t = tokens.float()
    if similarity == "cosine":
        t = _l2_normalize(t, eps)
    elif similarity != "dot":
        raise ValueError(f"Unknown similarity function: {similarity}")
    return torch.matmul(t, t.transpose(-1, -2))


def gpf_fuse(
    r_anchor: torch.Tensor,
    r_positive: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    symmetric_enforce: bool = True,
) -> torch.Tensor:
    """G = sum_pq coeffs[p, q] * A_p(R_a) ⊙ A_q(R_p), symmetrized, clamped >= 0.

    A_0 = 1, A_1 = R, and every later power multiplies by clamp(R, 0), as
    running Hadamard powers.  ``coeffs`` is the already-nonnegative
    ``[P+1, Q+1]`` matrix.
    """
    P, Q = coeffs.shape[0] - 1, coeffs.shape[1] - 1
    ra_clamped = torch.clamp(r_anchor, min=0.0)
    rp_clamped = torch.clamp(r_positive, min=0.0)
    fused = torch.zeros_like(r_anchor)
    ra_pow = torch.ones_like(r_anchor)
    for p in range(P + 1):
        rp_pow = torch.ones_like(r_positive)
        for q in range(Q + 1):
            fused = fused + coeffs[p, q] * (ra_pow * rp_pow)
            rp_pow = rp_pow * (r_positive if q == 0 else rp_clamped)
        ra_pow = ra_pow * (r_anchor if p == 0 else ra_clamped)
    if symmetric_enforce:
        fused = 0.5 * (fused + fused.transpose(-1, -2))
    return torch.clamp(fused, min=0.0)


def normalize_graph(
    graph: torch.Tensor, method: str = "symmetric", eps: float = 1e-8
) -> torch.Tensor:
    """'symmetric': D^-1/2 A D^-1/2; 'random_walk': D^-1 A."""
    degrees = torch.sum(graph, dim=-1)
    if method == "symmetric":
        inv_sqrt = torch.rsqrt(torch.clamp(degrees, min=eps))
        return graph * inv_sqrt[..., :, None] * inv_sqrt[..., None, :]
    if method == "random_walk":
        inv = 1.0 / torch.clamp(degrees, min=eps)
        return graph * inv[..., :, None]
    raise ValueError(f"Unknown normalization method: {method}")
