"""Class-style loss wrappers: the counterpart of
``ego_moment_cle_vit_tpu/losses/modules.py``.

Each class holds its configuration and is called with the arguments of the
matching function in ``.triplet`` / ``.alignment``, which it delegates to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from . import alignment as A
from . import triplet as T


@dataclasses.dataclass
class TripletLoss:
    """max(d(a,p) - d(a,n) + margin, 0)."""

    margin: float = 1.0
    p_norm: int = 2
    normalize: bool = True
    reduction: str = "mean"

    def __call__(self, anchor, positive, negative):
        return T.triplet_loss(anchor, positive, negative, margin=self.margin,
                              normalize=self.normalize, reduction=self.reduction)


@dataclasses.dataclass
class HardTripletLoss:
    """Online hard-negative mining over a batch."""

    margin: float = 1.0
    normalize: bool = True
    hard_positive: bool = False
    reduction: str = "mean"

    def __call__(self, embeddings, labels):
        return T.hard_triplet_loss(embeddings, labels, margin=self.margin,
                                   normalize=self.normalize, hard_positive=self.hard_positive,
                                   reduction=self.reduction)


@dataclasses.dataclass
class MultiViewTripletLoss:
    """Multiple positive views and a negative-sampling strategy.  'random'
    draws from ``generator``, or from a generator seeded 0 on the anchors'
    device when none is given (the JAX wrapper's ``PRNGKey(0)``)."""

    margin: float = 1.0
    normalize: bool = True
    num_positives: int = 1
    negative_sampling: str = "random"
    temperature: float = 0.1

    def __call__(self, anchor, positive, labels, generator: Optional[torch.Generator] = None):
        if generator is None and self.negative_sampling == "random":
            generator = torch.Generator(device=anchor.device).manual_seed(0)
        return T.multiview_triplet_loss(anchor, positive, labels, margin=self.margin,
                                        normalize=self.normalize,
                                        negative_sampling=self.negative_sampling,
                                        generator=generator)


@dataclasses.dataclass
class KernelAlignmentLoss:
    """1 - alignment(graph, labels)."""

    alignment_type: str = "centered"
    temperature: float = 1.0
    reduction: str = "mean"

    def __call__(self, graph, labels):
        return A.kernel_alignment_loss(graph, labels, self.alignment_type)


@dataclasses.dataclass
class ContrastiveAlignmentLoss:
    """Margin push / pull on pairwise graph-mean products."""

    temperature: float = 0.1
    margin: float = 0.5
    positive_weight: float = 1.0
    negative_weight: float = 1.0

    def __call__(self, graph, labels):
        return A.contrastive_alignment_loss(graph, labels, margin=self.margin,
                                            positive_weight=self.positive_weight,
                                            negative_weight=self.negative_weight)


@dataclasses.dataclass
class HierarchicalAlignmentLoss:
    """Alignment over spatially pooled graph scales."""

    scales: Sequence[int] = (1, 2, 4)
    scale_weights: Optional[Sequence[float]] = None
    alignment_type: str = "centered"

    def __call__(self, graph, labels):
        return A.hierarchical_alignment_loss(graph, labels, scales=self.scales,
                                             scale_weights=self.scale_weights,
                                             alignment_type=self.alignment_type)
