"""Graph-alignment losses.

Counterpart of ``ego_moment_cle_vit_tpu/losses/alignment.py:25-34, 90-99``
(``label_similarity_matrix``, ``graph_alignment_mse_loss``).  The CKA,
contrastive and hierarchical variants are not ported yet.
"""

from __future__ import annotations

import torch

from .triplet import _not_ported


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
    label_sim = (labels[:, None] == labels[None, :]).to(graph.dtype)
    g = graph.mean(dim=(1, 2))
    sim = torch.sigmoid(torch.outer(g, g))
    return torch.mean(torch.square(sim - label_sim))


def kernel_alignment_loss(*args, **kwargs):
    raise _not_ported("kernel_alignment_loss (CKA)")


def contrastive_alignment_loss(*args, **kwargs):
    raise _not_ported("contrastive_alignment_loss")


def hierarchical_alignment_loss(*args, **kwargs):
    raise _not_ported("hierarchical_alignment_loss")
