"""The port's dense Newton–Schulz route (kernel 5) against the JAX package.

On the CPU, numpy inputs from a seed:

* ``newton_schulz_isqrt_plain`` (the kernel's order) against
  ``newton_schulz_isqrt_pallas`` (its fp32 ``_ns_kernel`` in interpret mode)
  at [2, 64, 64], M in fp32 and bf16, within the tolerances
  ``tests/test_pallas_kernels.py`` holds that kernel to (1e-2 absolute + 1e-4
  relative: fp32 sum order through the steps, and in bf16 one rounding of the
  output, under 2^-7 of values near one); and against the JAX package's plain
  ``newton_schulz_isqrt`` in its default (three-product) form, which orders
  each update as ``0.5 (3Y - Y ZY)`` (1e-6 absolute in fp32: sum order; one
  bf16 ulp of the output, 2^-7 relative, in bf16).
* The gradient: ``NewtonSchulzFunction`` (the kernel's forward, autograd over
  the plain iteration backward, as the TPU package's ``custom_vjp``) against
  ``jax.grad`` through ``newton_schulz_isqrt_pallas`` (1e-3 absolute and
  relative, as the JAX package holds its kernel's gradient), and ``gradcheck``
  in fp64.
* The dense-route ``MomentHead`` (N >= D) against the JAX ``MomentHead`` with
  the same flax weights and sketch matrices: features within 1e-4 of their
  largest entry, the gradients to tokens and graph within 2e-4 of theirs
  (fp32 sum order through the covariance, five NS steps and the head MLP).
* ``kernel_supports`` is the TPU kernel's ``_fp32_fits``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models.moment_head import MomentHead as JMomentHead
from ego_moment_cle_vit_tpu.ops import moments as jmoments
from ego_moment_cle_vit_tpu.ops.pallas.newton_schulz import (
    _fp32_fits,
    newton_schulz_isqrt_pallas,
)
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as tns
from ego_moment_cle_vit_tpu_torch.models.moment_head import MomentHead, check_dense_route
from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)


def _spd(b, d, seed):
    """Symmetric positive definite matrices, as the JAX package's kernel tests draw them."""
    a = np.random.default_rng(seed).standard_normal((b, d, d)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) / d + 0.5 * np.eye(d, dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iterations", [3, 5])
def test_forward_matches_the_pallas_kernel(dtype, iterations):
    m = _spd(2, 64, 12)
    jm = jnp.asarray(m).astype(dtype)
    ref = np.asarray(newton_schulz_isqrt_pallas(jm, iterations, 1e-5).astype(jnp.float32))
    tm = torch.from_numpy(m).to(getattr(torch, dtype))
    out = tns.newton_schulz_isqrt_plain(tm, iterations, 1e-5)
    assert out.dtype == tm.dtype and out.shape == (2, 64, 64)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iterations", [3, 5])
def test_plain_iteration_matches_jax(dtype, iterations):
    m = _spd(3, 40, 13)
    ref = np.asarray(jmoments.newton_schulz_isqrt(jnp.asarray(m).astype(dtype), iterations,
                                                  1e-5).astype(jnp.float32))
    out = tns.newton_schulz_isqrt_plain(torch.from_numpy(m).to(getattr(torch, dtype)),
                                        iterations, 1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0**-7, atol=0)


def test_gradient_matches_jax_grad_through_the_pallas_kernel():
    m = _spd(2, 16, 12)
    ref = jax.grad(lambda x: jnp.sum(newton_schulz_isqrt_pallas(x, 5, 1e-5) ** 2))(
        jnp.asarray(m))
    x = torch.from_numpy(m).requires_grad_()
    (tns.newton_schulz_isqrt_kernel(x, 5, 1e-5) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_function_gradcheck_fp64():
    m = torch.from_numpy(_spd(2, 8, 14)).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda x: tns.newton_schulz_isqrt_kernel(x, 3, 1e-5), (m,))


def test_kernel_supports_is_fp32_fits():
    for d in (1, 64, 192, 768, 824, 825, 826, 1024, 1536):
        assert tns.kernel_supports(d) == _fp32_fits(d), d
    assert tns.kernel_supports(768) and not tns.kernel_supports(1024)


def test_wrapper_takes_the_plain_version_on_the_cpu_without_counting():
    m = torch.from_numpy(_spd(2, 24, 15))
    before = tns.newton_schulz_isqrt_fwd.launches
    assert torch.equal(tns.newton_schulz_isqrt_fwd(m, 5, 1e-5),
                       tns.newton_schulz_isqrt_plain(m, 5, 1e-5))
    assert tns.newton_schulz_isqrt_fwd.launches == before


def test_dense_route_raises_on_the_card_only_past_the_fp32_kernel():
    """Checked through the rule the head and ``create_model`` apply."""
    check_dense_route(768, "cuda")  # ViT-Base at 448: the fp32 kernel
    check_dense_route(1024, "cpu")  # the plain iteration on the CPU
    with pytest.raises(NotImplementedError, match="ROADMAP.*5′.*5″"):
        check_dense_route(1024, "cuda")  # ViT-Large at 512: kernel 5′, not ported
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_dense_route(1536, torch.device("cuda"))  # Swin-Large: kernel 5″


@pytest.mark.parametrize("use_third_order", [False, True])
def test_dense_route_moment_head_matches_jax(use_third_order):
    b, n, d = 2, 40, 32  # N >= D: the dense route
    rng = np.random.default_rng(16)
    tokens = rng.standard_normal((b, n, d)).astype(np.float32)
    feats = rng.random((b, n, 6)).astype(np.float32)
    graph = feats @ feats.transpose(0, 2, 1)  # non-negative, symmetric
    kw = dict(d_in=d, d_out=32, use_third_order=use_third_order, isqrt_iterations=5,
              sketch_dim=64)
    jhead = JMomentHead(**kw)
    variables = jax.tree_util.tree_map(np.asarray, jhead.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(graph)))
    # biases and norm parameters away from their init, so each conversion matters
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32), variables["params"])
    variables = {**variables, "params": params}

    def jax_loss(t, g):
        return jnp.sum(jnp.sin(jhead.apply(variables, t, g)))

    ref = np.asarray(jhead.apply(variables, jnp.asarray(tokens), jnp.asarray(graph)))
    ref_dt, ref_dg = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(tokens), jnp.asarray(graph))

    head = MomentHead(d, 32, use_third_order, 5, 64, dropout=0.1).eval()
    head.load_state_dict(torch_state_dict_from_flax(variables, head, device="cpu"))
    t = torch.from_numpy(tokens).requires_grad_()
    g = torch.from_numpy(graph).requires_grad_()
    out = head(t, g)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    torch.sin(out).sum().backward()
    for got, want in ((t.grad, ref_dt), (g.grad, ref_dg)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())
