"""Plain PyTorch math ops (graphs, moments, sketch)."""

from .graph import gpf_fuse, normalize_graph, token_similarity_graph
from .moments import (
    degree_weighted_centered_mean,
    graph_weighted_mean,
    half_vectorize_paired,
    isqrt_cov_subspace,
)
from .sketch import effective_sketch_dim, make_sketch_matrices, tensor_sketch_3

__all__ = [
    "gpf_fuse",
    "normalize_graph",
    "token_similarity_graph",
    "degree_weighted_centered_mean",
    "graph_weighted_mean",
    "half_vectorize_paired",
    "isqrt_cov_subspace",
    "effective_sketch_dim",
    "make_sketch_matrices",
    "tensor_sketch_3",
]
