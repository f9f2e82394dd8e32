"""Graph-weighted moment pooling head.

Counterpart of ``ego_moment_cle_vit_tpu/models/moment_head.py:73-233``
(``MomentHead``): symmetric graph normalization, weighted mean and
centering, iSQRT-COV in the token subspace (N < D) or on the dense route
(N >= D: ``M2 = Zc^T W Zc`` formed in fp32, cast to the tokens' dtype and
handed to the Newton–Schulz kernel, as the JAX head hands it to
``newton_schulz_isqrt_pallas``), paired half-vectorization, ``second_proj``
-> LayerNorm -> GELU -> Dropout, and the third-order Tensor-Sketch branch.
``norm='batch'`` and ``SimplifiedMomentHead`` are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import newton_schulz as _ns
from ..ops.graph import normalize_graph
from ..ops.moments import (
    _wide,
    degree_weighted_centered_mean,
    graph_weighted_mean,
    half_vectorize_paired,
    isqrt_cov_subspace,
)
from ..ops.sketch import effective_sketch_dim, make_sketch_matrices, tensor_sketch_3
from .layers import Dense, Dropout, LayerNorm

# flax nn.LayerNorm's default epsilon, which the JAX head norms keep
HEAD_NORM_EPS = 1e-6


def check_dense_route(d: int, device: str | torch.device) -> None:
    """Raise where the dense route cannot run: on the card, a width past the
    fp32 Newton–Schulz kernel.  The TPU package takes such widths with its
    bf16 variants, which are not ported; the plain iteration is never
    substituted on the card."""
    if torch.device(device).type == "cuda" and not _ns.kernel_supports(d):
        raise NotImplementedError(
            f"the dense Newton–Schulz route at D={d} is past the fp32 kernel (D <= 825); the "
            "TPU package's bf16 variants for wider matrices are not ported yet (ROADMAP.md, "
            "'TPU kernels to port', 5′ _ns_kernel_bf16 and 5″ _ns_kernel_bf16_streamed)"
        )


def _head_norm(kind: str, dim: int, device) -> nn.Module:
    if kind == "layer":
        return LayerNorm(dim, eps=HEAD_NORM_EPS, out_dtype=torch.float32, device=device)
    if kind in ("batch", "none"):
        raise NotImplementedError(
            f"norm={kind!r} is not ported yet (ROADMAP.md, 'Modules to port', heads)"
        )
    raise ValueError(f"Unknown norm kind: {kind}")


class MomentHead(nn.Module):
    """[B, N, D] tokens + [B, N, N] fused graph -> [B, d_out] moment features.

    The count-sketch matrices are a non-trainable buffer, the counterpart of
    the JAX ``constants`` collection.  A fresh model draws them from the
    generator given to :meth:`reset_sketch`; that draw differs from JAX's
    ``PRNGKey(sketch_seed)`` one, and the weight converter carries the JAX
    matrices across when outputs must match.
    """

    def __init__(self, d_in: int, d_out: int = 512, use_third_order: bool = False,
                 isqrt_iterations: int = 3, sketch_dim: int = 2048, sketch_mode: str = "fft",
                 eps: float = 1e-5, norm: str = "layer",
                 bf16_params: bool = False, dtype=torch.float32, device="cpu",
                 dropout: float = 0.1):
        super().__init__()
        if sketch_mode not in ("fft", "faithful"):
            raise ValueError(f"Unknown tensor-sketch mode: {sketch_mode}")
        self.d_in, self.d_out = d_in, d_out
        self.use_third_order = use_third_order
        self.isqrt_iterations = isqrt_iterations
        self.sketch_mode = sketch_mode
        self.eps = eps
        self.dtype = dtype
        self.d_second = d_out // 2 if use_third_order else d_out
        self.d_third = d_out - self.d_second if use_third_order else 0
        self.sketch_dim = sketch_dim
        self.drop = Dropout(dropout)

        self.second_proj = Dense(
            d_in * (d_in + 1) // 2, self.d_second, dtype=dtype,
            param_dtype=torch.bfloat16 if bf16_params else dtype, device=device,
        )
        self.second_norm = _head_norm(norm, self.d_second, device)
        if use_third_order:
            k = effective_sketch_dim(d_in, sketch_dim)
            self.register_buffer(
                "sketch_matrices", torch.zeros(3, d_in, k, dtype=torch.float32, device=device)
            )
            self.third_proj = Dense(k, self.d_third, dtype=dtype, device=device)
            self.third_norm = _head_norm(norm, self.d_third, device)

    @torch.no_grad()
    def reset_sketch(self, generator: torch.Generator) -> None:
        if self.use_third_order:
            self.sketch_matrices.copy_(make_sketch_matrices(
                self.d_in, self.sketch_dim, generator=generator,
                device=self.sketch_matrices.device,
            ))

    def forward(self, tokens: torch.Tensor, graph: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        n_tok, d_tok = tokens.shape[-2], tokens.shape[-1]
        dense = n_tok >= d_tok
        if dense:
            check_dense_route(d_tok, tokens.device)
        w = normalize_graph(graph, "symmetric", eps=self.eps)
        mu = graph_weighted_mean(tokens, w, eps=self.eps)
        centered = tokens - mu[:, None, :]
        weighted = torch.matmul(_wide(w), _wide(centered)).to(tokens.dtype)
        if dense:
            m2 = torch.matmul(_wide(centered).transpose(-1, -2), _wide(weighted))
            m2 = _ns.newton_schulz_isqrt_kernel(m2.to(tokens.dtype), self.isqrt_iterations,
                                                self.eps)
        else:
            m2 = isqrt_cov_subspace(centered, weighted, self.isqrt_iterations, self.eps)
        m2_vec = half_vectorize_paired(m2).to(self.dtype)
        x = F.gelu(self.second_norm(self.second_proj(m2_vec)), approximate="none")
        x = self.drop(x, generator)
        if not self.use_third_order:
            return x
        third = tensor_sketch_3(
            degree_weighted_centered_mean(centered, w, eps=self.eps), self.sketch_matrices,
            self.sketch_mode,
        ).to(self.dtype)
        y = F.gelu(self.third_norm(self.third_proj(third)), approximate="none")
        y = self.drop(y, generator)
        return torch.cat([x, y], dim=-1)


class SimplifiedMomentHead(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SimplifiedMomentHead is not ported yet (ROADMAP.md, 'Modules to port', heads)"
        )
