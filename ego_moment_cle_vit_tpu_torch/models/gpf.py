"""Graph Polynomial Fusion module (static coefficients).

Counterpart of ``ego_moment_cle_vit_tpu/models/gpf.py:44-107``: softplus of
the raw ``alpha_coeffs`` parameter, then the fused GPF through
``kernels.gpf.gpf`` (forward and backward CUDA kernels on the card, their
plain versions on the CPU).  ``AdaptiveGraphPolynomialFusion`` is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import gpf as _gpf


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


class AdaptiveGraphPolynomialFusion(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "AdaptiveGraphPolynomialFusion is not ported yet (ROADMAP.md, 'Modules to port', "
            "heads)"
        )
