"""The port's loss functions against the JAX package's, on shared numpy inputs.

fp32 on the CPU.  Every loss is a mean over a handful of O(1) terms, so the
two frameworks differ by sum order only: tolerance 1e-6 absolute (2e-6
absolute plus 2e-6 relative for the triplet variants, whose unnormalized
distances reach ~15).  Every variant and mode of ``losses/triplet.py`` and
``losses/alignment.py`` and the six class wrappers of ``losses/modules.py``;
'random' mining against a numpy evaluation on the port's own draw.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ego_moment_cle_vit_tpu import losses as jl
from ego_moment_cle_vit_tpu.models.ego_moment_clevit import cross_entropy_loss as j_cross_entropy
from ego_moment_cle_vit_tpu_torch import losses as tl
from ego_moment_cle_vit_tpu_torch.losses import alignment as tl_alignment
from ego_moment_cle_vit_tpu_torch.models.ego_moment_clevit import cross_entropy_loss

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)


def _features(seed, b=6, d=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("squared", [True, False])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_triplet_loss_matches_jax(normalize, squared, reduction):
    a, p, n = _features(0)
    kwargs = dict(margin=0.7, normalize=normalize, squared=squared, reduction=reduction)
    ref = np.asarray(jl.triplet_loss(jnp.asarray(a), jnp.asarray(p), jnp.asarray(n), **kwargs))
    out = tl.triplet_loss(torch.from_numpy(a), torch.from_numpy(p), torch.from_numpy(n), **kwargs)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("margin", [0.3, 1.5])
def test_roll_negative_triplet_loss_matches_jax(margin):
    a, p, _ = _features(1)
    ref = float(jl.roll_negative_triplet_loss(jnp.asarray(a), jnp.asarray(p), margin=margin))
    out = tl.roll_negative_triplet_loss(torch.from_numpy(a), torch.from_numpy(p), margin=margin)
    assert abs(out.item() - ref) <= 1e-6
    # the negative of sample i is anchor i-1: rolling the other way is another loss
    ta_, tp_ = torch.from_numpy(a), torch.from_numpy(p)
    per_sample = tl.triplet_loss(ta_, tp_, torch.roll(ta_, 1, 0), margin=margin, squared=True,
                                 reduction="none")
    other = tl.triplet_loss(ta_, tp_, torch.roll(ta_, -1, 0), margin=margin, squared=True,
                            reduction="none")
    assert abs(per_sample.mean().item() - ref) <= 1e-6
    assert (per_sample - other).abs().max() > 1e-2


@pytest.mark.parametrize("normalize", [True, False])
def test_label_similarity_matrix_matches_jax(normalize):
    labels = np.array([3, 1, 3, 2, 1, 3], np.int32)
    ref = np.asarray(jl.label_similarity_matrix(jnp.asarray(labels), normalize=normalize))
    out = tl.label_similarity_matrix(torch.from_numpy(labels), normalize=normalize)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed", [2, 3])
def test_graph_alignment_mse_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    graph = rng.uniform(0, 2, size=(5, 9, 9)).astype(np.float32)
    labels = rng.integers(0, 3, size=(5,)).astype(np.int32)
    ref = float(jl.graph_alignment_mse_loss(jnp.asarray(graph), jnp.asarray(labels)))
    out = tl.graph_alignment_mse_loss(torch.from_numpy(graph), torch.from_numpy(labels))
    assert abs(out.item() - ref) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_entropy_loss_matches_jax(dtype):
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(7, 10)).astype(np.float32) * 3).to(dtype)
    labels = rng.integers(0, 10, size=(7,)).astype(np.int32)
    # both sides take the (possibly bf16) logits to fp32 first
    ref = float(j_cross_entropy(jnp.asarray(logits.float().numpy()), jnp.asarray(labels)))
    out = cross_entropy_loss(logits, torch.from_numpy(labels))
    assert out.dtype == torch.float32
    assert abs(out.item() - ref) <= 1e-6


def _mining_batch(seed, b=8, d=16, k=None):
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=(b, d)).astype(np.float32)
    shape = (b, d) if k is None else (b, k, d)
    positive = (rng.normal(size=shape) * 0.7).astype(np.float32)
    if k is None:
        positive += anchor
    else:
        positive += anchor[:, None]
    labels = np.array([0, 1, 0, 2, 1, 3, 0, 2], np.int32)[:b]
    return anchor, positive, labels


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("hard_positive", [True, False])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_hard_triplet_loss_matches_jax(normalize, hard_positive, reduction):
    emb, _, labels = _mining_batch(6)
    labels[5] = 9  # an anchor without a positive is left out of the mean
    kw = dict(margin=0.8, normalize=normalize, hard_positive=hard_positive,
              reduction=reduction)
    ref = np.asarray(jl.hard_triplet_loss(jnp.asarray(emb), jnp.asarray(labels), **kw))
    out = tl.hard_triplet_loss(torch.from_numpy(emb), torch.from_numpy(labels), **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("views", [None, 3])
@pytest.mark.parametrize("mining", ["hard", "semi-hard"])
@pytest.mark.parametrize("normalize", [True, False])
def test_multiview_triplet_loss_matches_jax(views, mining, normalize):
    anchor, positive, labels = _mining_batch(7, k=views)
    kw = dict(margin=1.2, normalize=normalize, negative_sampling=mining)
    ref = float(jl.multiview_triplet_loss(jnp.asarray(anchor), jnp.asarray(positive),
                                          jnp.asarray(labels), **kw))
    out = tl.multiview_triplet_loss(torch.from_numpy(anchor), torch.from_numpy(positive),
                                    torch.from_numpy(labels), **kw)
    assert abs(out.item() - ref) <= 2e-6 + 2e-6 * abs(ref)


def _multiview_numpy(anchor, positive, labels, margin, idx):
    """The multi-view loss with the negatives given as indices into the 2B set
    [anchors; view k], in numpy float64: the reference for a random draw."""
    a = anchor / np.linalg.norm(anchor, axis=-1, keepdims=True)
    p = positive / np.linalg.norm(positive, axis=-1, keepdims=True)
    b, k = p.shape[0], p.shape[1]
    total, count = 0.0, 0
    for i in range(b):
        if not (labels != labels[i]).any():
            continue
        for v in range(k):
            j = idx[i, v]
            cand = a[j] if j < b else p[j - b, v]
            assert labels[j % b] != labels[i]  # a different-class candidate
            neg = np.sqrt(np.sum((a[i] - cand) ** 2) + 1e-12)
            pos = np.sqrt(np.sum((a[i] - p[i, v]) ** 2) + 1e-12)
            total += max(pos - neg + margin, 0.0)
            count += 1
    return total / max(count, 1)


def test_multiview_random_mining_draws_negatives_from_the_generator():
    """'random' mining: the JAX draw cannot be reproduced, so the loss is held
    to a numpy evaluation on the indices the port drew (1e-5 relative); the
    same seed draws the same indices, another seed others, and over many draws
    every different-class candidate of an anchor comes up."""
    anchor, positive, labels = _mining_batch(8, k=2)
    args = [torch.from_numpy(anchor), torch.from_numpy(positive), torch.from_numpy(labels)]
    loss, idx = tl.multiview_triplet_loss(*args, margin=1.0, negative_sampling="random",
                                          generator=torch.Generator().manual_seed(3),
                                          return_indices=True)
    ref = _multiview_numpy(anchor, positive, labels, 1.0, idx.numpy())
    assert abs(loss.item() - ref) <= 1e-5 * abs(ref)
    _, again = tl.multiview_triplet_loss(*args, negative_sampling="random",
                                         generator=torch.Generator().manual_seed(3),
                                         return_indices=True)
    assert torch.equal(idx, again)
    seen = set()
    g = torch.Generator().manual_seed(4)
    for _ in range(200):
        _, i = tl.multiview_triplet_loss(*args, negative_sampling="random", generator=g,
                                         return_indices=True)
        seen.update(i[0].tolist())
    assert seen == {j for j in range(16) if labels[j % 8] != labels[0]}
    with pytest.raises(ValueError, match="Generator"):
        tl.multiview_triplet_loss(*args, negative_sampling="random")


def _graph_batch(seed, b=6, n=16):
    rng = np.random.default_rng(seed)
    graph = rng.uniform(0, 2, size=(b, n, n)).astype(np.float32)
    graph += rng.uniform(0, 1, size=(b, 1, 1)).astype(np.float32)  # samples' means differ
    labels = np.array([0, 1, 0, 2, 1, 0], np.int32)[:b]
    return graph, labels


@pytest.mark.parametrize("alignment_type", ["centered", "normalized", "cosine"])
@pytest.mark.parametrize("square", [False, True])
def test_kernel_alignment_loss_matches_jax(alignment_type, square):
    graph, labels = _graph_batch(9)
    if square:  # a [B, B] similarity passes through
        graph = graph[:, :6, :6].mean(axis=0)
    ref = float(jl.kernel_alignment_loss(jnp.asarray(graph), jnp.asarray(labels),
                                         alignment_type))
    out = tl.kernel_alignment_loss(torch.from_numpy(graph), torch.from_numpy(labels),
                                   alignment_type)
    assert abs(out.item() - ref) <= 1e-6


@pytest.mark.parametrize("margin, weights", [(0.5, (1.0, 1.0)), (0.2, (2.0, 0.5))])
@pytest.mark.parametrize("square", [False, True])
def test_contrastive_alignment_loss_matches_jax(margin, weights, square):
    graph, labels = _graph_batch(10)
    graph *= 0.6
    if square:  # the diagonal of a [B, B] input
        graph = graph[:, :6, :6].mean(axis=0)
    kw = dict(margin=margin, positive_weight=weights[0], negative_weight=weights[1])
    ref = float(jl.contrastive_alignment_loss(jnp.asarray(graph), jnp.asarray(labels), **kw))
    out = tl.contrastive_alignment_loss(torch.from_numpy(graph), torch.from_numpy(labels), **kw)
    assert ref > 0 and abs(out.item() - ref) <= 1e-6


@pytest.mark.parametrize("alignment_type", ["centered", "normalized", "cosine"])
@pytest.mark.parametrize("scales, weights", [((1, 2, 4), None), ((1, 2, 3), (0.5, 1.0, 2.0))])
def test_hierarchical_alignment_loss_matches_jax(alignment_type, scales, weights):
    """N = 16 = 4^2 pools at 2 and 4; 3 does not divide 4, so that scale
    passes the graph through, as in the JAX package."""
    graph, labels = _graph_batch(11)
    rng = np.random.default_rng(12)
    graph = graph * rng.uniform(0.5, 1.5, size=graph.shape[1:]).astype(np.float32)
    kw = dict(scales=scales, scale_weights=weights, alignment_type=alignment_type)
    ref = float(jl.hierarchical_alignment_loss(jnp.asarray(graph), jnp.asarray(labels), **kw))
    out = tl.hierarchical_alignment_loss(torch.from_numpy(graph), torch.from_numpy(labels),
                                         **kw)
    assert abs(out.item() - ref) <= 1e-6 * max(1.0, abs(ref))
    pooled = tl_alignment._pool_graph(torch.from_numpy(graph), 2).numpy()
    from ego_moment_cle_vit_tpu.losses.alignment import _pool_graph as j_pool
    np.testing.assert_allclose(pooled, np.asarray(j_pool(jnp.asarray(graph), 2)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["TripletLoss", "HardTripletLoss", "MultiViewTripletLoss",
                                  "KernelAlignmentLoss", "ContrastiveAlignmentLoss",
                                  "HierarchicalAlignmentLoss"])
def test_loss_wrappers_match_jax(name):
    """The six class wrappers, with their defaults but one option changed,
    against the JAX ones (the multi-view wrapper with hard mining: its default
    random draw differs by framework)."""
    a, p, labels = _mining_batch(13)
    n = np.roll(a, 1, axis=0)
    graph, glabels = _graph_batch(14)
    options = {"TripletLoss": {"margin": 0.5}, "HardTripletLoss": {"hard_positive": True},
               "MultiViewTripletLoss": {"negative_sampling": "semi-hard"},
               "KernelAlignmentLoss": {"alignment_type": "cosine"},
               "ContrastiveAlignmentLoss": {"margin": 0.3},
               "HierarchicalAlignmentLoss": {"scales": (1, 2)}}[name]
    args = {"TripletLoss": (a, p, n), "HardTripletLoss": (a, labels),
            "MultiViewTripletLoss": (a, p, labels), "KernelAlignmentLoss": (graph, glabels),
            "ContrastiveAlignmentLoss": (graph * 0.6, glabels),
            "HierarchicalAlignmentLoss": (graph, glabels)}[name]
    ref = float(getattr(jl, name)(**options)(*[jnp.asarray(x) for x in args]))
    out = getattr(tl, name)(**options)(*[torch.from_numpy(x) for x in args])
    assert abs(out.item() - ref) <= 2e-6 + 2e-6 * abs(ref)
    if name == "MultiViewTripletLoss":  # the default draws from a generator seeded 0
        rand = tl.MultiViewTripletLoss()
        x = [torch.from_numpy(v) for v in args]
        assert torch.equal(rand(*x), rand(*x))
