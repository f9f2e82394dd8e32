"""The port's loss functions against the JAX package's, on shared numpy inputs.

fp32 on the CPU.  Every loss is a mean over a handful of O(1) terms, so the
two frameworks differ by sum order only: tolerance 1e-6 absolute (2e-6
absolute plus 2e-6 relative for the triplet variants, whose unnormalized
distances reach ~15).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ego_moment_cle_vit_tpu import losses as jl
from ego_moment_cle_vit_tpu.models.ego_moment_clevit import cross_entropy_loss as j_cross_entropy
from ego_moment_cle_vit_tpu_torch import losses as tl
from ego_moment_cle_vit_tpu_torch.losses import alignment as tl_alignment
from ego_moment_cle_vit_tpu_torch.losses import triplet as tl_triplet
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


@pytest.mark.parametrize("fn", [
    tl_triplet.hard_triplet_loss, tl_triplet.multiview_triplet_loss,
    tl_alignment.kernel_alignment_loss, tl_alignment.contrastive_alignment_loss,
    tl_alignment.hierarchical_alignment_loss,
])
def test_unported_loss_variants_raise(fn):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn(torch.zeros(2, 4), torch.zeros(2, dtype=torch.long))
