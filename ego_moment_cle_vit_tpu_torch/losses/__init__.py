"""Loss functions of the training step (pure functions on tensors)."""

from .alignment import graph_alignment_mse_loss, label_similarity_matrix
from .triplet import roll_negative_triplet_loss, triplet_loss

__all__ = [
    "graph_alignment_mse_loss",
    "label_similarity_matrix",
    "roll_negative_triplet_loss",
    "triplet_loss",
]
