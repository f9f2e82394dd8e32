"""Graph-weighted moment pooling heads.

Counterpart of ``ego_moment_cle_vit_tpu/models/moment_head.py``.
``MomentHead``: symmetric graph normalization, weighted mean and centering,
iSQRT-COV in the token subspace (N < D; on the card without a gradient, the
kernel of ``kernels/subspace_isqrt.py``) or on the dense route (N >= D, or
any N with ``isqrt_subspace=False``: ``M2 = Zc^T W Zc`` formed in fp32, cast
to the tokens' dtype and handed to the Newton–Schulz kernels, as the JAX
head hands it to ``newton_schulz_isqrt_pallas``), paired half-vectorization,
``second_proj`` -> Norm -> GELU -> Dropout, and the third-order Tensor-Sketch
branch (its sketch capped at 2 D with ``sketch_compact``, else 4 D).
``remat`` checkpoints the iSQRT step, as the JAX head's ``jax.checkpoint``.
Norm is LayerNorm ('layer'), BatchNorm with running statistics ('batch') or
none.  ``SimplifiedMomentHead``: random-walk weights, the single-matrix
Newton–Schulz square root in plain fp32 products (no kernel, as the JAX head
runs it in XLA), the row-major vech, and a cubed random projection for the
third order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import newton_schulz as _ns
from ..kernels import subspace_isqrt as _si
from ..ops.graph import normalize_graph
from ..ops.moments import (
    _wide,
    degree_weighted_centered_mean,
    graph_weighted_covariance,
    graph_weighted_mean,
    half_vectorize,
    half_vectorize_paired,
    isqrt_cov_subspace,
)
from ..ops.sketch import effective_sketch_dim, make_sketch_matrices, tensor_sketch_3
from .layers import BatchNorm, Dense, Dropout, LayerNorm

# flax nn.LayerNorm's default epsilon, which the JAX head norms keep
HEAD_NORM_EPS = 1e-6


def check_dense_route(d: int, device: str | torch.device) -> None:
    """Raise where the dense route cannot run: on the card, a width that none
    of the three Newton–Schulz kernels takes (``variant_for(d)`` is None: D
    past 1059 other than 1536).  The TPU package runs its XLA iteration there;
    the plain iteration is never substituted on the card."""
    if torch.device(device).type == "cuda" and _ns.variant_for(d) is None:
        raise NotImplementedError(f"the dense moment route: {_ns.unsupported_width(d)}")


def _on_card(t: torch.Tensor) -> bool:
    """Whether the subspace kernel can take ``t`` (the dispatch test replaces
    this to reach the kernel's branch on the CPU)."""
    return t.is_cuda


def _head_norm(kind: str, dim: int, device) -> nn.Module:
    """The heads' norm switch (JAX ``_Norm``): fp32 LayerNorm, fp32 BatchNorm
    with running statistics, or the identity."""
    if kind == "layer":
        norm = LayerNorm(dim, eps=HEAD_NORM_EPS, out_dtype=torch.float32, device=device)
        norm.flax_level = "LayerNorm_0"  # the JAX _Norm wraps the flax module
        return norm
    if kind == "batch":
        return BatchNorm(dim, device=device)
    if kind == "none":
        return nn.Identity()
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
                 dropout: float = 0.1, remat: bool = False, sketch_compact: bool = False,
                 isqrt_subspace: bool = True):
        super().__init__()
        if sketch_mode not in ("fft", "faithful"):
            raise ValueError(f"Unknown tensor-sketch mode: {sketch_mode}")
        self.d_in, self.d_out = d_in, d_out
        self.sketch_cap = 2 if sketch_compact else 4
        self.isqrt_subspace = isqrt_subspace
        self.use_third_order = use_third_order
        self.isqrt_iterations = isqrt_iterations
        self.sketch_mode = sketch_mode
        self.eps = eps
        self.remat = remat
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
            k = effective_sketch_dim(d_in, sketch_dim, self.sketch_cap)
            self.register_buffer(
                "sketch_matrices", torch.zeros(3, d_in, k, dtype=torch.float32, device=device)
            )
            self.third_proj = Dense(k, self.d_third, dtype=dtype, device=device)
            self.third_norm = _head_norm(norm, self.d_third, device)

    @torch.no_grad()
    def reset_sketch(self, generator: torch.Generator) -> None:
        if self.use_third_order:
            self.sketch_matrices.copy_(make_sketch_matrices(
                self.d_in, self.sketch_dim, self.sketch_cap, generator=generator,
                device=self.sketch_matrices.device,
            ))

    def dense_route(self, n_tok: int, d_tok: int) -> bool:
        return not (self.isqrt_subspace and n_tok < d_tok)

    def _isqrt(self, centered: torch.Tensor, weighted: torch.Tensor) -> torch.Tensor:
        """The iSQRT step, JAX's ``isqrt_fn``: on the dense route M2 = Zc^T W
        Zc in fp32, cast to the tokens' dtype, then Newton–Schulz; else the
        token-subspace iteration, on the card without a gradient (serving,
        evaluation) as the subspace kernel.  Where a gradient is wanted it stays
        ``isqrt_cov_subspace`` under autograd: the kernel has no backward, and
        recomputing the plain forward in the backward, as
        ``NewtonSchulzFunction`` does, would add that forward's ~44 ms to a
        ViT-L/448 training step."""
        if self.dense_route(*centered.shape[-2:]):
            m2 = torch.matmul(_wide(centered).transpose(-1, -2), _wide(weighted))
            return _ns.newton_schulz_isqrt_kernel(m2.to(centered.dtype), self.isqrt_iterations,
                                                  self.eps)
        if _on_card(centered) and not (centered.requires_grad or weighted.requires_grad):
            return _si.subspace_isqrt_fwd(centered, weighted, self.isqrt_iterations, self.eps)
        return isqrt_cov_subspace(centered, weighted, self.isqrt_iterations, self.eps)

    def forward(self, tokens: torch.Tensor, graph: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.dense_route(*tokens.shape[-2:]):
            check_dense_route(tokens.shape[-1], tokens.device)
        w = normalize_graph(graph, "symmetric", eps=self.eps)
        mu = graph_weighted_mean(tokens, w, eps=self.eps)
        centered = tokens - mu[:, None, :]
        weighted = torch.matmul(_wide(w), _wide(centered)).to(tokens.dtype)
        if self.remat and torch.is_grad_enabled():
            # saves centered and weighted, recomputes the step in backward;
            # nothing in it is stochastic
            m2 = checkpoint(self._isqrt, centered, weighted, use_reentrant=False,
                            preserve_rng_state=False)
        else:
            m2 = self._isqrt(centered, weighted)
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
    """The lightweight head (JAX ``moment_head.py:236-297``): W = G / rowsum
    (random-walk normalization), M2 = (Z - mu)^T W (Z - mu), the
    single-matrix Newton–Schulz iteration ``Y <- 0.5 Y (3I - Y^2)`` on the
    trace-normalized M2 in fp32 (an approximate square root, de-normalized by
    sqrt(trace)), the row-major vech -> ``second_proj`` -> GELU -> Dropout;
    with the third order, ``third_rp`` (no bias) of the degree-weighted mean
    cubed -> Dropout.  No norm layers, no kernel."""

    def __init__(self, d_in: int, d_out: int = 512, use_third_order: bool = False,
                 isqrt_iterations: int = 3, eps: float = 1e-5, dropout: float = 0.1,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.use_third_order = use_third_order
        self.isqrt_iterations = isqrt_iterations
        self.eps = eps
        self.dtype = dtype
        self.d_out = d_out
        self.d_second = d_out // 2 if use_third_order else d_out
        self.drop = Dropout(dropout)
        self.second_proj = Dense(d_in * (d_in + 1) // 2, self.d_second, dtype=dtype,
                                 device=device)
        if use_third_order:
            self.third_rp = Dense(d_in, d_out - self.d_second, bias=False, dtype=dtype,
                                  device=device)

    def reset_sketch(self, generator: torch.Generator) -> None:
        """Nothing to draw: this head has no sketch."""

    def forward(self, tokens: torch.Tensor, graph: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        w = normalize_graph(graph, "random_walk", eps=self.eps)
        mu = graph_weighted_mean(tokens, w, eps=self.eps)
        m2, centered = graph_weighted_covariance(tokens, w, mean=mu, eps=self.eps)
        m32 = _wide(m2)
        trace = torch.diagonal(m32, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        eye = torch.eye(m32.shape[-1], dtype=m32.dtype, device=m32.device)
        y = m32 / (trace + self.eps)
        for _ in range(self.isqrt_iterations):
            y = 0.5 * torch.matmul(y, 3.0 * eye - torch.matmul(y, y))
        sqrt_m = (y * torch.sqrt(trace + self.eps)).to(self.dtype)
        x = self.drop(F.gelu(self.second_proj(half_vectorize(sqrt_m)), approximate="none"),
                      generator)
        if not self.use_third_order:
            return x
        pooled = degree_weighted_centered_mean(centered, w, eps=self.eps)
        y3 = self.drop(self.third_rp(pooled) ** 3, generator)
        return torch.cat([x, y3], dim=-1)
