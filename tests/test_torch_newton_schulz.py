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
* The width predicates are the TPU package's (``_fp32_fits``,
  ``_bf16_resident_fits``, ``_bf16_streamed_fits``), and the card's dense
  route takes every width one of them takes (the bf16 variants in
  ``tests/test_torch_newton_schulz_bf16.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models.moment_head import MomentHead as JMomentHead
from ego_moment_cle_vit_tpu.ops import moments as jmoments
from ego_moment_cle_vit_tpu.ops.pallas.newton_schulz import (
    _bf16_resident_fits,
    _bf16_streamed_fits,
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
    """Each kernel variant's width predicate is its TPU kernel's."""
    for d in (1, 64, 192, 768, 824, 825, 826, 1024, 1059, 1060, 1536, 2048):
        assert tns.fp32_fits(d) == _fp32_fits(d), d
        assert tns.bf16_resident_fits(d) == _bf16_resident_fits(d), d
        assert tns.bf16_streamed_fits(d) == _bf16_streamed_fits(d), d
    assert tns.fp32_fits(768) and not tns.fp32_fits(1024)
    assert [tns.variant_for(d) for d in (768, 1024, 1536, 1100)] == [
        "fp32", "bf16", "bf16_streamed", None]


@pytest.mark.parametrize("b", [1, 3, 32, 33, 64, 65, 128])
def test_fp32_geometry_passes_and_scratch(b):
    """Kernel 5's passes cover the batch as its launch loop walks it (passes
    of ``images``, the last one short), none over FP32_PASS_IMAGES; its plane
    rows take D on the 8-element TMA pitch; its scratch holds the batch's
    traces and four matrices' three planes for a pass, and from the serving
    batch (64) on no more than the five fp32 matrices an image the kernel
    took before its planes (past the narrowest widths, whose pitch pads most)."""
    for d in range(1, 826):
        g = tns.fp32_geometry(b, d)
        walked = [min(g["images"], b - b0) for b0 in range(0, b, g["images"])]
        assert len(walked) == g["passes"] and min(walked) >= 1 and sum(walked) == b
        assert g["images"] <= tns.FP32_PASS_IMAGES
        assert max(walked) - min(walked) <= 1 or g["passes"] == 1
        assert g["pitch"] % 8 == 0 and d <= g["pitch"] < d + 8
        planes = tns.FP32_SCRATCH_MATRICES * tns.FP32_PLANES * g["images"] * d * g["pitch"]
        assert g["scratch_bytes"] == -(-4 * b // 256) * 256 + 2 * planes
        if b >= 64 and d >= 16:
            assert g["scratch_bytes"] <= (5 * b * d * d + b) * 4
    with pytest.raises(ValueError, match="B, D >= 1"):
        tns.fp32_geometry(0, 768)


def test_wrapper_takes_the_plain_version_on_the_cpu_without_counting():
    m = torch.from_numpy(_spd(2, 24, 15))
    before = tns.newton_schulz_isqrt_fp32_fwd.launches
    for fwd in (tns.newton_schulz_isqrt_fp32_fwd, tns.newton_schulz_isqrt_fwd):
        assert torch.equal(fwd(m, 5, 1e-5), tns.newton_schulz_isqrt_plain(m, 5, 1e-5))
    assert tns.newton_schulz_isqrt_fp32_fwd.launches == before


def test_dense_route_raises_on_the_card_only_past_the_fp32_kernel():
    """Checked through the rule the head and ``create_model`` apply: the card
    takes the fp32 kernel's widths and the bf16 variants' (5′ at 826-1059,
    5″ at 1536), and raises, naming ROADMAP, only where no variant fits."""
    check_dense_route(768, "cuda")  # ViT-Base at 448: the fp32 kernel
    check_dense_route(1024, "cpu")  # the plain iteration on the CPU
    check_dense_route(1024, "cuda")  # ViT-Large at 512: kernel 5′
    check_dense_route(1536, torch.device("cuda"))  # Swin-Large at 1280: kernel 5″
    for d in (1100, 2048):  # past 5′ and off 5″'s grid: no variant
        check_dense_route(d, "cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            check_dense_route(d, "cuda")


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
