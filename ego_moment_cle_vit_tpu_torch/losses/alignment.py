"""Graph-alignment losses.

Counterpart of ``ego_moment_cle_vit_tpu/losses/alignment.py``: the label and
graph similarity matrices, the alignment MSE the model's loss uses, kernel
alignment (centered / CKA, normalized, cosine), the contrastive margin loss on
pairwise graph-mean products, and the hierarchical alignment over spatially
pooled graphs.  Pair loops are outer products and masked means.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def label_similarity_matrix(labels: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Y[i, j] = 1 where labels match, else 0; optionally unit Frobenius norm."""
    sim = (labels[:, None] == labels[None, :]).float()
    if normalize:
        fro = torch.sqrt(torch.sum(torch.square(sim)))
        sim = torch.where(fro > 0, sim / fro, sim)
    return sim


def graph_alignment_mse_loss(graph: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MSE between the sigmoid of the outer product of per-sample mean graph
    activations and the binary label-similarity matrix.  graph [B, N, N]."""
    return alignment_mse_from_means(graph.mean(dim=(1, 2)), labels)


def alignment_mse_from_means(g: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``graph_alignment_mse_loss`` from the per-sample graph means ``g`` [B]
    (on a mesh the means are gathered, not the [B, N, N] graphs)."""
    label_sim = (labels[:, None] == labels[None, :]).to(g.dtype)
    sim = torch.sigmoid(torch.outer(g, g))
    return torch.mean(torch.square(sim - label_sim))


def graph_global_similarity(graph: torch.Tensor) -> torch.Tensor:
    """[B, N, N] graphs -> [B, B] outer product of the per-sample mean
    activations; a [B, B] input passes through."""
    if graph.dim() == 2:
        return graph
    if graph.dim() == 3:
        g = graph.mean(dim=(1, 2))
        return torch.outer(g, g)
    raise ValueError(f"Unsupported graph rank: {graph.dim()}")


def _centered_alignment(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """CKA between two [B, B] kernels, centered by H = I - 11^T / B."""
    b = k1.shape[0]
    h = (torch.eye(b, dtype=k1.dtype, device=k1.device)
         - torch.ones(b, b, dtype=k1.dtype, device=k1.device) / b)
    k1c = h @ k1 @ h
    k2c = h @ k2 @ h
    num = torch.sum(k1c * k2c)
    den = torch.sqrt(torch.sum(k1c * k1c) * torch.sum(k2c * k2c))
    return torch.where(den > 0, num / den, 0.0)


def kernel_alignment_loss(graph: torch.Tensor, labels: torch.Tensor,
                          alignment_type: str = "centered") -> torch.Tensor:
    """1 - alignment(graph similarity, unit-Frobenius label similarity):
    'centered' (CKA), 'normalized' (Frobenius inner product of the unit
    kernels) or 'cosine' (of the flattened kernels)."""
    graph_sim = graph_global_similarity(graph)
    label_sim = label_similarity_matrix(labels, normalize=True).to(graph_sim.dtype)
    if alignment_type == "centered":
        return 1.0 - _centered_alignment(graph_sim, label_sim)
    if alignment_type == "normalized":
        gn = torch.sqrt(torch.sum(torch.square(graph_sim)))
        ln = torch.sqrt(torch.sum(torch.square(label_sim)))
        align = torch.sum((graph_sim / torch.clamp(gn, min=1e-12))
                          * (label_sim / torch.clamp(ln, min=1e-12)))
        return torch.where((gn > 0) & (ln > 0), 1.0 - align, 1.0)
    if alignment_type == "cosine":
        gf, lf = graph_sim.reshape(-1), label_sim.reshape(-1)
        cos = torch.dot(gf, lf) / torch.clamp(torch.linalg.norm(gf) * torch.linalg.norm(lf),
                                              min=1e-12)
        return 1.0 - cos
    raise ValueError(f"Unknown alignment type: {alignment_type}")


def contrastive_alignment_loss(graph: torch.Tensor, labels: torch.Tensor, margin: float = 0.5,
                               positive_weight: float = 1.0,
                               negative_weight: float = 1.0) -> torch.Tensor:
    """Over the unordered pairs i < j of per-sample graph means g (the
    diagonal of a [B, B] input): same class max(margin - g_i g_j, 0) x
    positive_weight, else max(g_i g_j - (1 - margin), 0) x negative_weight;
    the mean over pairs."""
    g = graph.mean(dim=(1, 2)) if graph.dim() == 3 else torch.diagonal(graph)
    b = g.shape[0]
    iu = torch.triu_indices(b, b, offset=1, device=g.device)
    sim = torch.outer(g, g)[iu[0], iu[1]]
    same = (labels[:, None] == labels[None, :])[iu[0], iu[1]]
    pos = torch.clamp(margin - sim, min=0.0) * positive_weight
    neg = torch.clamp(sim - (1.0 - margin), min=0.0) * negative_weight
    return torch.where(same, pos, neg).sum() / max(sim.shape[0], 1)


def _pool_graph(graph: torch.Tensor, scale: int) -> torch.Tensor:
    """Average-pool a [B, N, N] spatial relation graph by ``scale`` along each
    of its four spatial axes (N = h^2 with h divisible by ``scale``; other
    graphs pass through)."""
    if scale == 1:
        return graph
    b, n, _ = graph.shape
    h = int(round(n ** 0.5))
    if h * h != n or h % scale != 0:
        return graph
    ph = h // scale
    g = graph.reshape(b, ph, scale, ph, scale, ph, scale, ph, scale)
    return g.mean(dim=(2, 4, 6, 8)).reshape(b, ph * ph, ph * ph)


def hierarchical_alignment_loss(graph: torch.Tensor, labels: torch.Tensor,
                                scales: Sequence[int] = (1, 2, 4),
                                scale_weights: Optional[Sequence[float]] = None,
                                alignment_type: str = "centered") -> torch.Tensor:
    """The weighted sum of ``kernel_alignment_loss`` over the graph pooled at
    each scale."""
    if scale_weights is None:
        scale_weights = [1.0] * len(scales)
    total = 0.0
    for scale, weight in zip(scales, scale_weights):
        total = total + weight * kernel_alignment_loss(_pool_graph(graph, scale), labels,
                                                       alignment_type)
    return total
