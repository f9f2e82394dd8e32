"""Graph-weighted moment pooling math.

Counterpart of ``ego_moment_cle_vit_tpu/ops/moments.py:192-225, 291-307,
336-413``: the paired half-vectorization, the graph-weighted means and the
token-subspace iSQRT-COV.  Products accumulate in fp32 and results are cast
back to the token dtype, as in the JAX package.  The dense Newton–Schulz
route (N >= D) is not ported yet.
"""

from __future__ import annotations

import torch


def half_vectorize_paired(matrix: torch.Tensor) -> torch.Tensor:
    """Packed upper triangle in the JAX package's PAIRED order.

    Padding the flat row-major ``[D*D]`` by D and reshaping to ``[D, D+1]``
    puts upper-triangle row i at ``T[i, :D-i]``; rows i and D-1-i together
    hold D+1 entries, so the reversed partner row is right-aligned into row
    i.  The order must match exactly, or converted ``second_proj`` rows stop
    lining up.  D must be even.
    """
    dim = matrix.shape[-1]
    if dim % 2 != 0:
        raise NotImplementedError(
            "half_vectorize_paired needs an even D (every supported backbone "
            "width is even)"
        )
    batch_shape = matrix.shape[:-2]
    flat = matrix.reshape(*batch_shape, dim * dim)
    padded = torch.nn.functional.pad(flat, (0, dim))
    t = padded.reshape(*batch_shape, dim, dim + 1)
    rows = torch.arange(dim, device=matrix.device)[:, None]
    cols = torch.arange(dim + 1, device=matrix.device)[None, :]
    u = torch.where(cols < dim - rows, t, torch.zeros((), dtype=t.dtype, device=t.device))
    top = u[..., : dim // 2, :]
    bottom = torch.flip(u[..., dim // 2 :, :], dims=(-2,))
    packed = top + torch.flip(bottom, dims=(-1,))
    return packed.reshape(*batch_shape, dim * (dim + 1) // 2)


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def graph_weighted_mean(
    tokens: torch.Tensor, weights: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """mu = (Z^T W 1) / tr(W): [B, N, D] x [B, N, N] -> [B, D]."""
    row_sums = torch.sum(weights.float(), dim=-1)
    weighted_sum = torch.einsum("bnd,bn->bd", tokens.float(), row_sums)
    trace_w = _trace(weights.float())[..., None]
    return (weighted_sum / (trace_w + eps)).to(tokens.dtype)


def degree_weighted_centered_mean(
    centered: torch.Tensor, weights: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Third-order input: sum_n Zc[n] * rowsum(W)[n] / tr(W)."""
    return graph_weighted_mean(centered, weights, eps)


def isqrt_cov_subspace(
    centered: torch.Tensor,
    weighted: torch.Tensor,
    num_iterations: int = 3,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Coupled Newton–Schulz M2^-1/2 for M2 = Zc^T (W Zc), run in the N-dim
    token subspace (exact for N < D; see the JAX docstring for the algebra).

    centered, weighted: [B, N, D] -> [B, D, D] in the input dtype; fp32
    inside.
    """
    in_dtype = centered.dtype
    a = centered.float()
    b = weighted.float()
    n, d = a.shape[-2], a.shape[-1]

    trace = torch.sum(a * b, dim=(-2, -1))[..., None, None]
    bh = b / (trace + eps)
    s = torch.matmul(bh, a.transpose(-1, -2))  # S = B̂ A^T  [B, N, N]

    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    a_k = 1.0
    g = torch.zeros_like(s)
    for _ in range(num_iterations):
        sg = torch.matmul(s, g)
        h = (a_k * a_k) * eye + torch.matmul(s, 2.0 * a_k * g + torch.matmul(g, sg))
        g = 1.5 * g - 0.5 * (a_k * h + torch.matmul(g, torch.matmul(s, h)))
        a_k = 1.5 * a_k

    gb = torch.matmul(g, bh)  # [B, N, D]
    out = torch.matmul(a.transpose(-1, -2), gb)  # A^T (G B̂)  [B, D, D]
    out.diagonal(dim1=-2, dim2=-1).add_(a_k)
    out = out / torch.sqrt(trace + eps)
    return out.to(in_dtype)
