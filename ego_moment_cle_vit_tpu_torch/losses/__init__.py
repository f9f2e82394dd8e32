"""Loss library: triplet losses and kernel-alignment losses (pure functions on
tensors), and class-style wrappers over them."""

from .alignment import (
    alignment_mse_from_means,
    contrastive_alignment_loss,
    graph_alignment_mse_loss,
    graph_global_similarity,
    hierarchical_alignment_loss,
    kernel_alignment_loss,
    label_similarity_matrix,
)
from .modules import (
    ContrastiveAlignmentLoss,
    HardTripletLoss,
    HierarchicalAlignmentLoss,
    KernelAlignmentLoss,
    MultiViewTripletLoss,
    TripletLoss,
)
from .triplet import (
    hard_triplet_loss,
    multiview_triplet_loss,
    roll_negative_triplet_loss,
    triplet_loss,
)

__all__ = [
    "triplet_loss",
    "hard_triplet_loss",
    "multiview_triplet_loss",
    "roll_negative_triplet_loss",
    "kernel_alignment_loss",
    "contrastive_alignment_loss",
    "hierarchical_alignment_loss",
    "graph_alignment_mse_loss",
    "alignment_mse_from_means",
    "label_similarity_matrix",
    "graph_global_similarity",
    "TripletLoss",
    "HardTripletLoss",
    "MultiViewTripletLoss",
    "KernelAlignmentLoss",
    "ContrastiveAlignmentLoss",
    "HierarchicalAlignmentLoss",
]
