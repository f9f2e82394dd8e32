"""The PyTorch port's math ops against the JAX package, on shared numpy inputs.

Both frameworks run fp32 on the CPU.  Tolerances: 1e-5 relative to the
output's scale for single reductions (sum order differs between XLA and
PyTorch), 1e-4 for the Newton–Schulz chain and the FFT sketch, whose
iterated products and transforms compound that rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ego_moment_cle_vit_tpu.ops import graph as jgraph
from ego_moment_cle_vit_tpu.ops import moments as jmoments
from ego_moment_cle_vit_tpu.ops import sketch as jsketch
from ego_moment_cle_vit_tpu_torch.ops import graph as tgraph
from ego_moment_cle_vit_tpu_torch.ops import moments as tmoments
from ego_moment_cle_vit_tpu_torch.ops import sketch as tsketch


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, np.abs(b).max())
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _tokens(seed, b=2, n=49, d=64):
    return np.random.default_rng(seed).normal(size=(b, n, d)).astype(np.float32)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_token_similarity_graph(similarity):
    x = _tokens(0)
    x[0, 3] = 0.0  # a zero row exercises the cosine eps floor
    ref = jgraph.token_similarity_graph(jnp.asarray(x), similarity)
    out = tgraph.token_similarity_graph(torch.from_numpy(x), similarity)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("degrees", [(2, 2), (1, 3)])
def test_gpf_fuse(symmetric, degrees):
    rng = np.random.default_rng(1)
    ra = rng.normal(size=(2, 49, 49)).astype(np.float32)
    rp = rng.normal(size=(2, 49, 49)).astype(np.float32)
    c = rng.uniform(0.0, 1.0, size=(degrees[0] + 1, degrees[1] + 1)).astype(np.float32)
    ref = jgraph.gpf_fuse(jnp.asarray(ra), jnp.asarray(rp), jnp.asarray(c),
                          symmetric_enforce=symmetric)
    out = tgraph.gpf_fuse(torch.from_numpy(ra), torch.from_numpy(rp), torch.from_numpy(c),
                          symmetric_enforce=symmetric)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("method", ["symmetric", "random_walk"])
def test_normalize_graph(method):
    g = np.abs(np.random.default_rng(2).normal(size=(2, 49, 49))).astype(np.float32)
    ref = jgraph.normalize_graph(jnp.asarray(g), method, eps=1e-5)
    out = tgraph.normalize_graph(torch.from_numpy(g), method, eps=1e-5)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("dim", [2, 8, 128])
def test_half_vectorize_paired_exact_order(dim):
    m = np.random.default_rng(3).normal(size=(2, dim, dim)).astype(np.float32)
    ref = np.asarray(jmoments.half_vectorize_paired(jnp.asarray(m)))
    out = tmoments.half_vectorize_paired(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(out, ref)  # a pure permutation: bit-exact
    # and it is the documented permutation of the row-major vech
    perm = jmoments.paired_vech_permutation(dim)
    rows, cols = np.triu_indices(dim)
    np.testing.assert_array_equal(out, m[:, rows, cols][:, perm])


def test_half_vectorize_paired_odd_dim_raises():
    with pytest.raises(NotImplementedError):
        tmoments.half_vectorize_paired(torch.zeros(1, 5, 5))


def _graph_weights(seed, b=2, n=49):
    g = np.abs(np.random.default_rng(seed).normal(size=(b, n, n))).astype(np.float32)
    g = 0.5 * (g + g.transpose(0, 2, 1))
    return np.array(jgraph.normalize_graph(jnp.asarray(g), "symmetric", eps=1e-5))


@pytest.mark.parametrize("fn", ["graph_weighted_mean", "degree_weighted_centered_mean"])
def test_weighted_means(fn):
    x, w = _tokens(4), _graph_weights(5)
    ref = getattr(jmoments, fn)(jnp.asarray(x), jnp.asarray(w), eps=1e-5)
    out = getattr(tmoments, fn)(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5)
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("iterations", [3, 5])
def test_isqrt_cov_subspace_n49_d128(iterations):
    x, w = _tokens(6, n=49, d=128), _graph_weights(7)
    mu = jmoments.graph_weighted_mean(jnp.asarray(x), jnp.asarray(w), eps=1e-5)
    centered = np.array(jnp.asarray(x) - mu[:, None, :])
    weighted = np.einsum("bnm,bmd->bnd", w, centered).astype(np.float32)
    ref = jmoments.isqrt_cov_subspace(jnp.asarray(centered), jnp.asarray(weighted),
                                      iterations, 1e-5)
    out = tmoments.isqrt_cov_subspace(torch.from_numpy(centered), torch.from_numpy(weighted),
                                      iterations, 1e-5)
    assert out.shape == (2, 128, 128)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("mode", ["fft", "faithful"])
def test_tensor_sketch_3(mode):
    import jax

    d, k_arg = 64, 256
    params = jsketch.make_sketch_params(jax.random.PRNGKey(42), d, k_arg)
    x = np.random.default_rng(8).normal(size=(3, d)).astype(np.float32)
    ref = jsketch.tensor_sketch_3(jnp.asarray(x), params, mode=mode)
    out = tsketch.tensor_sketch_3(torch.from_numpy(x),
                                  torch.from_numpy(np.array(params.matrices)), mode)
    assert out.shape == (3, params.sketch_dim)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("d, k, cap", [(64, 256, 4), (1024, 4096, 4), (100, 4096, 2), (40, 50, 4)])
def test_sketch_dim_and_matrices(d, k, cap):
    eff = tsketch.effective_sketch_dim(d, k, cap)
    assert eff == jsketch.effective_sketch_dim(d, k, cap)
    mats = tsketch.make_sketch_matrices(d, k, cap, generator=torch.Generator().manual_seed(0))
    assert mats.shape == (3, d, eff)
    # one signed one-hot entry per input coordinate, like the JAX draw
    assert torch.equal((mats != 0).sum(-1), torch.ones(3, d, dtype=torch.long))
    assert set(mats.unique().tolist()) <= {-1.0, 0.0, 1.0}
