"""Graph Polynomial Fusion modules.

Counterpart of ``ego_moment_cle_vit_tpu/models/gpf.py``.
``GraphPolynomialFusion``: softplus of the raw ``alpha_coeffs`` parameter,
then the fused GPF through ``kernels.gpf.gpf`` (forward and backward CUDA
kernels on the card, their plain versions on the CPU).
``AdaptiveGraphPolynomialFusion``: the same coefficients made global,
per-sample or per-token-row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import gpf as _gpf
from ..ops.graph import gpf_fuse, token_similarity_graph
from .layers import Dense


class GraphPolynomialFusion(nn.Module):
    def __init__(self, degree_p: int = 2, degree_q: int = 2, similarity: str = "cosine",
                 eps: float = 1e-6, symmetric_enforce: bool = True, coeff_init: str = "uniform",
                 device="cpu"):
        super().__init__()
        if similarity not in ("cosine", "dot"):
            raise ValueError(f"Unknown similarity function: {similarity}")
        self.similarity = similarity
        self.eps = eps
        self.symmetric_enforce = symmetric_enforce
        self.coeff_init = coeff_init
        self.alpha_coeffs = nn.Parameter(
            torch.zeros(degree_p + 1, degree_q + 1, dtype=torch.float32, device=device)
        )

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers: 'uniform' U(0, 0.1), 'xavier'
        U(-a, a), 'identity' 0.01 with 0.5 at [0,0] and [1,1]."""
        a = self.alpha_coeffs
        if self.coeff_init == "uniform":
            a.uniform_(0.0, 0.1, generator=generator)
        elif self.coeff_init == "xavier":
            bound = (6.0 / (a.shape[0] + a.shape[1])) ** 0.5
            a.uniform_(-bound, bound, generator=generator)
        elif self.coeff_init == "identity":
            a.fill_(0.01)
            a[0, 0] = 0.5
            if a.shape[0] > 1 and a.shape[1] > 1:
                a[1, 1] = 0.5
        else:
            raise ValueError(f"Unknown initialization method: {self.coeff_init}")

    def coefficient_matrix(self) -> torch.Tensor:
        return F.softplus(self.alpha_coeffs)

    def forward(self, tokens_anchor: torch.Tensor, tokens_positive: torch.Tensor) -> torch.Tensor:
        """[B, N, D] x2 -> fused graph [B, N, N] fp32."""
        return _gpf.gpf(
            tokens_anchor, tokens_positive, self.coefficient_matrix().contiguous(),
            self.similarity, self.eps, self.symmetric_enforce,
        )


class AdaptiveGraphPolynomialFusion(GraphPolynomialFusion):
    """Adaptive-coefficient GPF (JAX ``models/gpf.py:110-198``).

    'global'    softplus(alpha) for every sample: the static module's
                function, through the fused GPF kernels (1 + 1 launches of
                kernels 2 / 2b a train step, 1 a serving forward).
    'attention' per-sample softplus(alpha + 0.1 delta_b), delta_b a Dense
                (``coeff_mod``, computed in fp32) of the two views' mean
                tokens ``[B, 2D]``.
    'spatial'   per-query-row softplus(alpha + 0.1 delta[i]), delta the
                zero-initialized ``spatial_coeffs [N, P+1, Q+1]``; the row
                asymmetry is folded back by the symmetrize step.

    'attention' and 'spatial' are plain PyTorch, as the JAX package runs them
    in XLA: kernel 2 takes one ``[P+1, Q+1]`` table, not per-sample or
    per-row coefficients, so they launch no GPF kernel.  ``num_tokens`` (N)
    sizes the spatial table.
    """

    def __init__(self, degree_p: int = 2, degree_q: int = 2, similarity: str = "cosine",
                 eps: float = 1e-6, symmetric_enforce: bool = True, coeff_init: str = "uniform",
                 adaptive_type: str = "global", num_tokens: int | None = None,
                 dim: int | None = None, dtype=torch.float32, device="cpu"):
        super().__init__(degree_p, degree_q, similarity, eps, symmetric_enforce, coeff_init,
                         device=device)
        self.adaptive_type = adaptive_type
        shape = (degree_p + 1, degree_q + 1)
        if adaptive_type == "attention":
            # flax Dense(dtype=None) computes in the promoted type of its input
            # and fp32 parameters
            self.coeff_mod = Dense(2 * dim, shape[0] * shape[1],
                                   dtype=torch.promote_types(dtype, torch.float32),
                                   device=device)
        elif adaptive_type == "spatial":
            self.spatial_coeffs = nn.Parameter(
                torch.zeros(num_tokens, *shape, dtype=torch.float32, device=device))
        elif adaptive_type != "global":
            raise ValueError(f"Unknown adaptive_type: {adaptive_type!r} "
                             "(expected 'global', 'spatial', or 'attention')")

    def forward(self, tokens_anchor: torch.Tensor, tokens_positive: torch.Tensor) -> torch.Tensor:
        if self.adaptive_type == "global":
            return super().forward(tokens_anchor, tokens_positive)
        r_a = token_similarity_graph(tokens_anchor, self.similarity, self.eps)
        r_p = token_similarity_graph(tokens_positive, self.similarity, self.eps)
        if self.adaptive_type == "attention":
            pooled = torch.cat([tokens_anchor.mean(dim=1), tokens_positive.mean(dim=1)], dim=-1)
            delta = self.coeff_mod(pooled).reshape(-1, *self.alpha_coeffs.shape)
            coeffs = F.softplus(self.alpha_coeffs[None] + 0.1 * delta)  # [B, P+1, Q+1]
            table = coeffs.permute(1, 2, 0)[..., None, None]  # [P+1, Q+1, B, 1, 1]
        else:
            coeffs = F.softplus(self.alpha_coeffs[None] + 0.1 * self.spatial_coeffs)  # [N, ...]
            table = coeffs.permute(1, 2, 0)[..., None]  # [P+1, Q+1, N, 1]: along the rows
        return gpf_fuse(r_a, r_p, table.to(r_a.dtype), symmetric_enforce=self.symmetric_enforce)
