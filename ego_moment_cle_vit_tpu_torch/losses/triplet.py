"""Triplet losses for the CLE-ViT instance-level contrast.

Counterpart of ``ego_moment_cle_vit_tpu/losses/triplet.py``: the triplet
loss, the roll-negative variant the model's loss uses, online hard mining over
a batch, and the multi-view loss with random, hard or semi-hard negatives.
Mining is masked min / max reductions over the batch, no per-anchor loop.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e9


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


def _pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances between the rows of x, [B, D] -> [B, B], from the
    Gram (the JAX package's form: sqrt(max(d2, 0) + 1e-12))."""
    sq = torch.sum(torch.square(x), dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    return torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12)


def hard_triplet_loss(
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    margin: float = 1.0,
    normalize: bool = True,
    hard_positive: bool = False,
    reduction: str = "mean",
) -> torch.Tensor:
    """Online hard-negative mining over a batch: per anchor, the positive
    statistic is the largest (``hard_positive``) or the mean distance to the
    other samples of its class, the negative one the smallest distance to
    another class; anchors without a positive or a negative count 0 and are
    left out of the mean."""
    if normalize:
        embeddings = _l2_normalize(embeddings)
    dist = _pairwise_distances(embeddings)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    pos_mask = same & ~eye
    neg_mask = ~same
    if hard_positive:
        pos_stat = torch.where(pos_mask, dist, -_BIG).amax(dim=1)
    else:
        pos_count = pos_mask.sum(dim=1)
        pos_stat = torch.where(pos_mask, dist, 0.0).sum(dim=1) / torch.clamp(pos_count, min=1)
    neg_stat = torch.where(neg_mask, dist, _BIG).amin(dim=1)
    valid = (pos_mask.sum(dim=1) > 0) & (neg_mask.sum(dim=1) > 0)
    per_anchor = torch.where(valid, torch.clamp(pos_stat - neg_stat + margin, min=0.0), 0.0)
    if reduction == "mean":
        return per_anchor.sum() / torch.clamp(valid.sum(), min=1)
    return _reduce(per_anchor, reduction)


def multiview_triplet_loss(
    anchor: torch.Tensor,
    positive: torch.Tensor,
    labels: torch.Tensor,
    margin: float = 1.0,
    normalize: bool = True,
    negative_sampling: str = "hard",
    generator: Optional[torch.Generator] = None,
    return_indices: bool = False,
):
    """Triplet loss with one or K positive views (``positive`` [B, D] or
    [B, K, D]) and negatives mined over the 2B set [anchors; view k], a
    different-class positive view being a candidate too:

    'random'    a different-class candidate drawn uniformly, from
                ``generator`` (required; the draw cannot reproduce JAX's);
    'hard'      the closest different-class candidate;
    'semi-hard' the closest inside (furthest positive - margin, furthest
                positive), else the hard one.

    ``return_indices`` also returns the mined candidates' indices into the
    2B set, ``[B, K]`` (for checking a random draw)."""
    if positive.dim() == 2:
        positive = positive[:, None, :]
    if normalize:
        anchor = _l2_normalize(anchor)
        positive = _l2_normalize(positive)
    b, k = anchor.shape[0], positive.shape[1]
    dist_aa = _pairwise_distances(anchor)  # [B, B]
    # anchor -> positive-view distances, [B, B, K]
    dist_ap = torch.sqrt(
        torch.sum(torch.square(anchor[:, None, None, :] - positive[None]), dim=-1) + 1e-12)
    dist2 = torch.cat([dist_aa[:, :, None].expand(b, b, k), dist_ap], dim=1)  # [B, 2B, K]
    neg_mask = labels[:, None] != labels[None, :]
    neg_mask2 = torch.cat([neg_mask, neg_mask], dim=1)[:, :, None]  # [B, 2B, 1]
    has_neg = neg_mask.sum(dim=1) > 0

    if negative_sampling == "random":
        if generator is None:
            raise ValueError("negative_sampling='random' requires a torch.Generator")
        u = torch.rand((b, 2 * b, k), generator=generator, device=anchor.device)
        scores = torch.where(neg_mask2, u, -1.0)
        idx = scores.argmax(dim=1)  # [B, K]: uniform among the candidates
        neg_d = torch.gather(dist2, 1, idx[:, None, :])[:, 0]
    elif negative_sampling in ("hard", "semi-hard"):
        hard_d = torch.where(neg_mask2, dist2, _BIG).amin(dim=1)
        idx = torch.where(neg_mask2, dist2, _BIG).argmin(dim=1)
        neg_d = hard_d
        if negative_sampling == "semi-hard":
            same = labels[:, None] == labels[None, :]
            eye = torch.eye(b, dtype=torch.bool, device=labels.device)
            pos_mask2 = torch.cat([same & ~eye, same], dim=1)[:, :, None]
            furthest = torch.where(pos_mask2, dist2, -_BIG).amax(dim=1)  # [B, K]
            semi = (neg_mask2 & (dist2 > (furthest - margin)[:, None])
                    & (dist2 < furthest[:, None]))
            semi_scores = torch.where(semi, dist2, _BIG)
            any_semi = semi.any(dim=1)
            neg_d = torch.where(any_semi, semi_scores.amin(dim=1), hard_d)
            idx = torch.where(any_semi, semi_scores.argmin(dim=1), idx)
    else:
        raise ValueError(f"Unknown negative sampling strategy: {negative_sampling}")

    pos_d = torch.sqrt(torch.sum(torch.square(anchor[:, None, :] - positive), dim=-1) + 1e-12)
    per = torch.where(has_neg[:, None], torch.clamp(pos_d - neg_d + margin, min=0.0), 0.0)
    loss = per.sum() / torch.clamp(has_neg.sum() * k, min=1)
    return (loss, idx) if return_indices else loss
