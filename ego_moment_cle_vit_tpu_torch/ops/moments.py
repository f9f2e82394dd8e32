"""Graph-weighted moment pooling math.

Counterpart of ``ego_moment_cle_vit_tpu/ops/moments.py:84-147, 192-413``:
the paired and the row-major half-vectorizations, the graph-weighted means
and covariance, the token-subspace iSQRT-COV, and the matrix utilities
(Newton–Schulz square root, eigen-powers, PSD check and projection).
Products accumulate in fp32 and results are cast back to the token dtype, as
in the JAX package.  The dense route (N >= D) takes its Newton–Schulz
iteration from ``kernels/newton_schulz.py``.
Everything here is differentiable by plain autograd (fp64 inputs stay fp64,
so ``gradcheck`` applies); the one in-place update, on the diagonal of a
fresh matmul result, touches nothing that autograd saved.
"""

from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The accumulation type: fp32, or fp64 when given fp64."""
    return t if t.dtype == torch.float64 else t.float()


def half_vectorize_paired(matrix: torch.Tensor) -> torch.Tensor:
    """Packed upper triangle in the JAX package's PAIRED order.

    Padding the flat row-major ``[D*D]`` by D and reshaping to ``[D, D+1]``
    puts upper-triangle row i at ``T[i, :D-i]``; rows i and D-1-i together
    hold D+1 entries, so the reversed partner row is right-aligned into row
    i.  The order must match exactly, or converted ``second_proj`` rows stop
    lining up.  An odd D has no partner rows: it takes the row-major vech,
    as the JAX function does (``paired_vech_permutation`` is then the
    identity).
    """
    dim = matrix.shape[-1]
    if dim % 2 != 0:
        return half_vectorize(matrix)
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


def paired_vech_permutation(dim: int):
    """numpy index array ``perm`` with ``half_vectorize_paired(M)[..., k] ==
    half_vectorize(M)[..., perm[k]]``: permutes the rows of a ``second_proj``
    kernel trained on the row-major vech into the paired order."""
    import numpy as np

    if dim % 2 != 0:
        return np.arange(dim * (dim + 1) // 2, dtype=np.int64)

    def k_ref(i, j):  # row-major vech index of (i, j), i <= j
        return i * dim - i * (i - 1) // 2 + (j - i)

    perm = np.empty(dim * (dim + 1) // 2, dtype=np.int64)
    width = dim + 1
    for pr in range(dim // 2):
        for col in range(width):
            if col < dim - pr:
                i, j = pr, pr + col  # the top row
            else:
                i, j = dim - 1 - pr, 2 * dim - 1 - pr - col  # the reversed partner row
                i, j = min(i, j), max(i, j)
            perm[pr * width + col] = k_ref(i, j)
    return perm


def half_vectorize(matrix: torch.Tensor) -> torch.Tensor:
    """Upper triangle (diagonal included), row-major: [..., D, D] ->
    [..., D(D+1)/2] in ``torch.triu_indices`` order, (0,0), (0,1), ...,
    (0,D-1), (1,1), ...  One gather; its backward scatters onto the upper
    triangle only, as the JAX custom VJP does."""
    dim = matrix.shape[-1]
    rows, cols = torch.triu_indices(dim, dim, device=matrix.device)
    flat = matrix.reshape(*matrix.shape[:-2], dim * dim)
    return flat[..., rows * dim + cols]


def half_vectorize_dim(dim: int) -> int:
    """Length of the half-vectorized representation: D(D+1)/2."""
    return dim * (dim + 1) // 2


def _trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def graph_weighted_mean(
    tokens: torch.Tensor, weights: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """mu = (Z^T W 1) / tr(W): [B, N, D] x [B, N, N] -> [B, D]."""
    row_sums = torch.sum(_wide(weights), dim=-1)
    weighted_sum = torch.einsum("bnd,bn->bd", _wide(tokens), row_sums.to(_wide(tokens).dtype))
    trace_w = _trace(_wide(weights))[..., None]
    return (weighted_sum / (trace_w + eps)).to(tokens.dtype)


def graph_weighted_covariance(
    tokens: torch.Tensor, weights: torch.Tensor, mean: torch.Tensor | None = None,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """M2 = (Z - mu)^T W (Z - mu): returns (M2 [B, D, D] in the tokens' dtype,
    the centered tokens [B, N, D]).  Both products accumulate in fp32."""
    if mean is None:
        mean = graph_weighted_mean(tokens, weights, eps=eps)
    centered = tokens - mean[:, None, :]
    weighted = torch.matmul(_wide(weights), _wide(centered))
    m2 = torch.matmul(_wide(centered).transpose(-1, -2), weighted)
    return m2.to(tokens.dtype), centered


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
    a = _wide(centered)
    b = _wide(weighted)
    n, d = a.shape[-2], a.shape[-1]

    trace = torch.sum(a * b, dim=(-2, -1))[..., None, None]
    bh = b / (trace + eps)
    s = torch.matmul(bh, a.transpose(-1, -2))  # S = B̂ A^T  [B, N, N]

    eye = torch.eye(n, dtype=a.dtype, device=a.device)
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


# ----------------------------------------------------------------------------
# matrix utilities (the JAX ``utils.ops`` re-exports)
# ----------------------------------------------------------------------------


def _sym32(matrix: torch.Tensor) -> torch.Tensor:
    return _wide(0.5 * (matrix + matrix.transpose(-1, -2)))


def newton_schulz_sqrt(matrix: torch.Tensor, num_iterations: int = 10,
                       eps: float = 1e-6) -> torch.Tensor:
    """Coupled Newton–Schulz iteration for M^{1/2}: trace-normalize, Y0 = M,
    Z0 = I, k steps of T = (3I - ZY) / 2, Y <- YT, Z <- TZ, then scale by
    sqrt(trace).  fp32 inside, the input dtype out."""
    m = _wide(matrix)
    dim = m.shape[-1]
    trace = _trace(m)[..., None, None]
    m = m / (trace + eps)
    eye = torch.eye(dim, dtype=m.dtype, device=m.device)
    y, z = m, eye.expand(m.shape)
    for _ in range(num_iterations):
        t = 0.5 * (3.0 * eye - torch.matmul(z, y))
        y = torch.matmul(y, t)
        z = torch.matmul(t, z)
    return (y * torch.sqrt(trace + eps)).to(matrix.dtype)


def matrix_power_eigen(matrix: torch.Tensor, power: float, eps: float = 1e-8) -> torch.Tensor:
    """M^power of the symmetric part of M through its eigendecomposition,
    eigenvalues clamped to >= eps first."""
    eigvals, eigvecs = torch.linalg.eigh(_sym32(matrix))
    eigvals = torch.clamp(eigvals, min=eps) ** power
    out = torch.einsum("...ij,...j,...kj->...ik", eigvecs, eigvals, eigvecs)
    return out.to(matrix.dtype)


def check_psd(matrix: torch.Tensor, tol: float = -1e-6) -> torch.Tensor:
    """Per matrix: is the smallest eigenvalue of the symmetric part >= tol."""
    return torch.linalg.eigvalsh(_sym32(matrix))[..., 0] >= tol


def ensure_psd(matrix: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Projection onto the PSD cone: eigenvalues clamped to >= eps."""
    return matrix_power_eigen(matrix, 1.0, eps)
