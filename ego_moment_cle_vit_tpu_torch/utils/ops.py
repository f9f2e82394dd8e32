"""Seeding and model introspection.

The port's counterpart of ``ego_moment_cle_vit_tpu/utils/ops.py``:
``set_seed``, ``count_parameters``, ``get_model_info`` and
``print_model_info``, and the matrix, graph and sketch helpers of ``..ops``
re-exported under the same names as there, so that ``utils.ops`` stays a
one-stop import.
"""

from __future__ import annotations

import random
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

# the math helpers, under the JAX module's names
from ..ops.graph import (  # noqa: F401
    batch_logdet,
    batch_trace,
    compute_graph_statistics,
    cosine_similarity_matrix,
    normalize_graph,
)
from ..ops.moments import (  # noqa: F401
    check_psd,
    ensure_psd,
    half_vectorize as half_vectorize_symmetric,
    matrix_power_eigen,
    newton_schulz_sqrt as matrix_sqrt_newton_schulz,
)
from ..ops.sketch import count_sketch, sketch_matrices_from_hashes  # noqa: F401


def set_seed(seed: int) -> torch.Generator:
    """Seed Python's and numpy's global generators and return the root
    ``torch.Generator`` (on the CPU), from which a run derives the generators
    it passes around explicitly."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def count_parameters(model: nn.Module) -> Dict[str, int]:
    """Total and trainable parameter counts."""
    params = list(model.parameters())
    return {"total": sum(p.numel() for p in params),
            "trainable": sum(p.numel() for p in params if p.requires_grad)}


def get_model_info(model: nn.Module, extra: Dict[str, Any] | None = None) -> Dict[str, Any]:
    counts = count_parameters(model)
    info = {
        "total_parameters": counts["total"],
        "trainable_parameters": counts["trainable"],
        "parameter_memory_mb": counts["total"] * 4 / 1024**2,
        "num_param_tensors": len(list(model.parameters())),
    }
    if extra:
        info.update(extra)
    return info


def print_model_info(model: nn.Module, name: str = "model") -> None:
    info = get_model_info(model)
    print(f"=== {name} ===")
    print(f"  parameters: {info['total_parameters']:,}")
    print(f"  fp32 memory: {info['parameter_memory_mb']:.1f} MB")
    print(f"  tensors: {info['num_param_tensors']}")
