"""Triplet losses for the CLE-ViT instance-level contrast.

Counterpart of ``ego_moment_cle_vit_tpu/losses/triplet.py:26-81``
(``triplet_loss``, ``roll_negative_triplet_loss``).  The hard-mining and
multi-view variants are not ported yet.
"""

from __future__ import annotations

import torch


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, 'Modules to port', loss variants)"
    )


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"Unknown reduction: {reduction}")


def triplet_loss(
    anchor: torch.Tensor,
    positive: torch.Tensor,
    negative: torch.Tensor,
    margin: float = 1.0,
    normalize: bool = True,
    squared: bool = False,
    reduction: str = "mean",
) -> torch.Tensor:
    """max(d(a,p) - d(a,n) + margin, 0) over ``[B, D]`` features.

    ``squared=False`` uses Euclidean distances, ``squared=True`` squared ones
    (the variant the model's loss uses).
    """
    if normalize:
        anchor = _l2_normalize(anchor)
        positive = _l2_normalize(positive)
        negative = _l2_normalize(negative)
    pos_sq = torch.sum(torch.square(anchor - positive), dim=-1)
    neg_sq = torch.sum(torch.square(anchor - negative), dim=-1)
    if squared:
        pos_d, neg_d = pos_sq, neg_sq
    else:
        pos_d, neg_d = torch.sqrt(pos_sq + 1e-12), torch.sqrt(neg_sq + 1e-12)
    return _reduce(torch.clamp(pos_d - neg_d + margin, min=0.0), reduction)


def roll_negative_triplet_loss(
    anchor: torch.Tensor, positive: torch.Tensor, margin: float = 0.3
) -> torch.Tensor:
    """In-batch negatives: the negative of sample i is anchor i-1 (the batch
    rolled by one); squared distances of L2-normalized features."""
    negative = torch.roll(anchor, shifts=1, dims=0)
    return triplet_loss(anchor, positive, negative, margin=margin, normalize=True, squared=True)


def hard_triplet_loss(*args, **kwargs):
    raise _not_ported("hard_triplet_loss")


def multiview_triplet_loss(*args, **kwargs):
    raise _not_ported("multiview_triplet_loss")
