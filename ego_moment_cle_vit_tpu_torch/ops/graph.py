"""Token-similarity graphs and Graph Polynomial Fusion math.

Counterpart of ``ego_moment_cle_vit_tpu/ops/graph.py``: the token graphs, the
polynomial fusion and its pieces, degree normalization, and the graph
utilities (trace, log-determinant, row cosine similarity, diagnostics).
Batch-first ``[B, N, D]`` tokens, ``[B, N, N]`` graphs; the Grams accumulate
in fp32.
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
    """[B, N, D] -> [B, N, N] fp32 Gram ('cosine' | 'dot'); fp64 tokens stay fp64."""
    t = tokens if tokens.dtype == torch.float64 else tokens.float()
    if similarity == "cosine":
        t = _l2_normalize(t, eps)
    elif similarity != "dot":
        raise ValueError(f"Unknown similarity function: {similarity}")
    return torch.matmul(t, t.transpose(-1, -2))


def hadamard_power(matrix: torch.Tensor, power: int) -> torch.Tensor:
    """Elementwise power: p = 0 all ones, p = 1 the matrix unclamped, p >= 2
    clamp(min=0) raised to p by repeated multiplication."""
    if power == 0:
        return torch.ones_like(matrix)
    if power == 1:
        return matrix
    clamped = torch.clamp(matrix, min=0.0)
    out = clamped
    for _ in range(power - 1):
        out = out * clamped
    return out


def symmetrize(matrix: torch.Tensor) -> torch.Tensor:
    """0.5 (G + G^T) over the trailing two dims."""
    return 0.5 * (matrix + matrix.transpose(-1, -2))


def gpf_fuse(
    r_anchor: torch.Tensor,
    r_positive: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    symmetric_enforce: bool = True,
    clamp: bool = True,
) -> torch.Tensor:
    """G = sum_pq coeffs[p, q] * A_p(R_a) ⊙ A_q(R_p), symmetrized, clamped >= 0.

    A_0 = 1, A_1 = R, and every later power multiplies by clamp(R, 0), as
    running Hadamard powers.  ``coeffs`` is the already-nonnegative
    ``[P+1, Q+1]`` matrix, or ``[P+1, Q+1, ...]`` whose entries broadcast
    against the graphs (per-sample or per-row coefficients).  ``clamp=False``
    returns the pre-activation (what the final clamp sees), which tells where
    its kink lies.
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
        fused = symmetrize(fused)
    return torch.clamp(fused, min=0.0) if clamp else fused


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


def batch_trace(matrices: torch.Tensor) -> torch.Tensor:
    """Trace over the trailing two dims: [..., D, D] -> [...]."""
    return torch.diagonal(matrices, dim1=-2, dim2=-1).sum(-1)


def batch_logdet(matrices: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """log det(M + eps I) through the Cholesky factor, its diagonal floored at
    eps, for PSD matrices."""
    dim = matrices.shape[-1]
    eye = torch.eye(dim, dtype=matrices.dtype, device=matrices.device)
    chol = torch.linalg.cholesky(matrices + eps * eye)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(torch.clamp(diag, min=eps)), dim=-1)


def cosine_similarity_matrix(x: torch.Tensor, y: torch.Tensor | None = None,
                             eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarity of the rows of x (and y): [N, D] (, [M, D])
    -> [N, M]."""
    if y is None:
        y = x
    return _l2_normalize(x, eps) @ _l2_normalize(y, eps).T


def compute_graph_statistics(graph: torch.Tensor, eps: float = 1e-8) -> dict:
    """Diagnostics of a batch of graphs, each a [B] tensor: symmetry error,
    smallest and largest eigenvalue of the symmetric part, mean degree,
    sparsity (share of entries under eps in magnitude), Frobenius norm."""
    sym_err = torch.amax(torch.abs(graph - graph.transpose(-1, -2)), dim=(-2, -1))
    eigvals = torch.linalg.eigvalsh(symmetrize(graph))
    return {
        "symmetry_error": sym_err,
        "min_eigenvalue": eigvals[..., 0],
        "max_eigenvalue": eigvals[..., -1],
        "mean_degree": torch.mean(torch.sum(graph, dim=-1), dim=-1),
        "sparsity": torch.mean((torch.abs(graph) < eps).to(graph.dtype), dim=(-2, -1)),
        "frobenius_norm": torch.sqrt(torch.sum(torch.square(graph), dim=(-2, -1))),
    }
