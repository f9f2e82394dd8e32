"""The port's bf16 Newton–Schulz variants (kernels 5′ and 5″) against the JAX
package, and the width dispatch they share with kernel 5.

On the CPU, numpy inputs from a seed:

* ``newton_schulz_isqrt_bf16_plain`` (kernel 5′'s rounding points) against
  ``_forward_bf16`` running ``_ns_kernel_bf16`` in interpret mode, at
  [2, 64, 64] and [2, 128, 128]; ``newton_schulz_isqrt_bf16_streamed_plain``
  (kernel 5″'s) against ``_forward_bf16(..., force_streamed=True)`` running
  ``_ns_kernel_bf16_streamed`` at [2, 512, 512], the smallest width on its
  grid.  M in fp32 and bf16, 3 and 5 iterations.  Tolerance per element
  ``|err| <= 2^-7 |ref| + 1e-4 max |ref|``: both sides round at the same
  points and differ only where an fp32 sum taken in another order lands on
  the other side of a bf16 rounding, one ulp (2^-8 to 2^-7 relative) of an
  element, which the later steps carry at the size of the matrix's entries
  (measured up to 6e-5 of max |ref|).  One iteration fewer must fail it.
* ``variant_for`` picks what the JAX ``_dispatch`` picks at every width in
  1..2048, and ``check_dense_route`` raises on the card exactly where it
  picks nothing.
* The wrappers take their plain versions for CPU tensors without counting a
  launch; ``NewtonSchulzFunction`` at a bf16 width (D = 1024) has the
  gradient of ``jax.grad`` through ``newton_schulz_isqrt_pallas``, whose
  backward differentiates the fp32 XLA iteration for every variant (1e-3
  absolute and relative, as the JAX package holds its kernel's gradient).
* The dense-route ``MomentHead`` at the bf16 variants' widths, D = 1024 with
  N = 1024 (ViT-Large at 512) and D = 1536 with N = 1600 (Swin-Large at 1280),
  against the JAX ``MomentHead``, fp32 (both take the fp32 iteration on the
  CPU): features within 1e-4 of their largest entry, and the gradient of
  every parameter, the tokens and the graph within 2e-4 of its largest entry
  (fp32 sum order through the covariance, five steps of 1024- or 1536-wide
  products and the head MLP).
* ``remat``: the head's output and every gradient equal those without it,
  bit for bit, on both routes.
* ``streamed_gemm_geometry``, the tiles of kernel 5″'s Hopper GEMM
  (``csrc/ns_sm90.cuh``): at every width it takes (multiples of 256 up to
  2048) its blocks and stages cover every row, column and contraction step,
  the TMA row strides stay on the 16-byte grain and a block fits an H100's
  shared memory; every other width in 1..2048 is refused, on the card's path
  only (the CPU wrapper takes the plain version at any width).
* ``bf16_gemm_geometry``, kernel 5′'s launches on that GEMM: every width in
  826..1059 padded to a multiple of the 256-column tile no wider than needed,
  its scratch of five padded matrices, a block within an H100's shared
  memory; every other width in 1..2048 refused.  The padding is exact: the
  kernel's recipe run plainly on M zero-padded to Dp (the trace taken of M,
  as the wrapper hands it in; Y starting as the identity on the leading D x D
  block) and cropped gives the unpadded plain iteration's bits, at D = 826,
  900 and 1059, M in fp32 and bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models.moment_head import MomentHead as JMomentHead
from ego_moment_cle_vit_tpu.ops.pallas.newton_schulz import (
    _bf16_resident_fits,
    _bf16_streamed_fits,
    _forward_bf16,
    _fp32_fits,
    newton_schulz_isqrt_pallas,
)
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as tns
from ego_moment_cle_vit_tpu_torch.models.layers import init_parameters
from ego_moment_cle_vit_tpu_torch.models.moment_head import MomentHead, check_dense_route
from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax

# the test workers share the cores: one intra-op thread per worker keeps
# torch's thread pools from contending with each other
torch.set_num_threads(1)

RTOL, ATOL = 2.0**-7, 1e-4  # per element: RTOL |ref| + ATOL max |ref|


def _spd(b, d, seed, rank=None):
    """Symmetric positive definite matrices, as the JAX package's kernel tests
    draw them."""
    a = np.random.default_rng(seed).standard_normal((b, d, rank or d)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) / (rank or d) + 0.5 * np.eye(d, dtype=np.float32)


def _excess(out, ref):
    """Largest |out - ref| / (RTOL |ref| + ATOL max |ref|); passes at <= 1."""
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    return float((np.abs(out - ref) / (RTOL * np.abs(ref) + ATOL * np.abs(ref).max())).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iterations", [3, 5])
@pytest.mark.parametrize("variant, d", [("bf16", 64), ("bf16", 128), ("bf16_streamed", 512)])
def test_bf16_twins_match_the_pallas_kernels(variant, d, iterations, dtype):
    streamed = variant == "bf16_streamed"
    twin = (tns.newton_schulz_isqrt_bf16_streamed_plain if streamed
            else tns.newton_schulz_isqrt_bf16_plain)
    m = _spd(2, d, 21 + d, rank=96 if streamed else None)
    ref = np.asarray(_forward_bf16(jnp.asarray(m).astype(dtype), iterations, 1e-5,
                                   force_streamed=streamed).astype(jnp.float32))
    tm = torch.from_numpy(m).to(getattr(torch, dtype))
    out = twin(tm, iterations, 1e-5)
    assert out.dtype == tm.dtype and out.shape == (2, d, d)
    assert _excess(out, ref) <= 1.0
    # the check has power: one iteration fewer falls outside it
    assert _excess(twin(tm, iterations - 1, 1e-5), ref) > 1.0


def _jax_choice(d):
    """The variant the JAX ``_dispatch`` runs (``_forward_bf16`` takes the
    resident kernel where it fits, else the streamed one)."""
    if _fp32_fits(d):
        return "fp32"
    if _bf16_resident_fits(d):
        return "bf16"
    if _bf16_streamed_fits(d):
        return "bf16_streamed"
    return None


def test_variant_for_is_the_jax_dispatch_and_the_card_raises_where_it_is_none():
    picked = {}
    for d in range(1, 2049):
        variant = tns.variant_for(d)
        assert variant == _jax_choice(d), d
        picked.setdefault(variant, []).append(d)
        if variant is None:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                check_dense_route(d, "cuda")
        else:
            check_dense_route(d, "cuda")
        check_dense_route(d, "cpu")
    assert (min(picked["fp32"]), max(picked["fp32"])) == (1, 825)
    assert (min(picked["bf16"]), max(picked["bf16"])) == (826, 1059)
    assert picked["bf16_streamed"] == [1536]
    # the registered widths (64, 192, 256, 384, 768, 1024, 1536) all have one
    assert all(tns.variant_for(d) for d in (64, 192, 256, 384, 768, 1024, 1536))


def test_bf16_wrappers_take_their_plain_versions_on_the_cpu_without_counting():
    m = torch.from_numpy(_spd(2, 40, 22))
    for fwd, plain in ((tns.newton_schulz_isqrt_bf16_fwd, tns.newton_schulz_isqrt_bf16_plain),
                       (tns.newton_schulz_isqrt_bf16_streamed_fwd,
                        tns.newton_schulz_isqrt_bf16_streamed_plain)):
        before = fwd.launches
        assert torch.equal(fwd(m, 5, 1e-5), plain(m, 5, 1e-5))
        assert fwd.launches == before
    # the dispatch keeps the fp32 iteration on the CPU at every width, as the
    # JAX package's CPU path does
    wide = torch.from_numpy(_spd(1, 1024, 23, rank=64))
    assert torch.equal(tns.newton_schulz_isqrt_fwd(wide, 2, 1e-5),
                       tns.newton_schulz_isqrt_plain(wide, 2, 1e-5))


def test_function_gradient_matches_jax_grad_at_a_bf16_width():
    m = _spd(1, 1024, 24, rank=128)
    assert _jax_choice(1024) == "bf16"
    cot = np.random.default_rng(25).standard_normal(m.shape).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(newton_schulz_isqrt_pallas(x, 5, 1e-5) * cot))(
        jnp.asarray(m))
    x = torch.from_numpy(m).requires_grad_()
    (tns.newton_schulz_isqrt_kernel(x, 5, 1e-5) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def _head_inputs(b, n, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    tokens = (scale * rng.standard_normal((b, n, d))).astype(np.float32)
    feats = rng.random((b, n, 6)).astype(np.float32)
    return tokens, feats @ feats.transpose(0, 2, 1), rng  # non-negative, symmetric graph


@pytest.mark.parametrize("use_third_order", [False, True])
@pytest.mark.parametrize("b, n, d", [(2, 1024, 1024), (1, 1600, 1536)])
def test_dense_route_moment_head_matches_jax_at_the_bf16_widths(b, n, d, use_third_order):
    # tokens at std 0.02.  The third-order sketch cubes the degree-weighted
    # mean, which grows with N (x ~800 here), and at larger token scales the
    # JAX head's fp32 token gradient leaves an fp64 evaluation of the same
    # head (0.26-0.39 of its largest entry at std 0.1, N = 1024) while the
    # port's stays within 1e-6 of it; at std 0.02 both are within 1e-6
    tokens, graph, rng = _head_inputs(b, n, d, 26, scale=0.02)
    kw = dict(d_in=d, d_out=16, use_third_order=use_third_order, isqrt_iterations=5,
              sketch_dim=64)
    jhead = JMomentHead(**kw)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jhead.init)(
        jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(graph)))
    # biases and norm parameters away from their init, so each conversion matters
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32), variables["params"])
    variables = {**variables, "params": params}
    cot = rng.standard_normal((b, 16)).astype(np.float32)

    def jax_loss(p, t, g):
        return jnp.sum(jhead.apply({**variables, "params": p}, t, g) * cot)

    ref = np.asarray(jax.jit(jhead.apply)(variables, jnp.asarray(tokens), jnp.asarray(graph)))
    ref_grads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        params, jnp.asarray(tokens), jnp.asarray(graph))

    head = MomentHead(d, 16, use_third_order, 5, 64, dropout=0.1).eval()
    head.load_state_dict(torch_state_dict_from_flax(variables, head, device="cpu"))
    t = torch.from_numpy(tokens).requires_grad_()
    g = torch.from_numpy(graph).requires_grad_()
    out = head(t, g)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    (out * torch.from_numpy(cot)).sum().backward()
    # the parameter gradients in the port's layout, through the converter
    named = dict(head.named_parameters())
    grad_state = torch_state_dict_from_flax(
        {**variables, "params": jax.tree_util.tree_map(np.asarray, ref_grads[0])}, head,
        device="cpu")
    want = {"tokens": ref_grads[1], "graph": ref_grads[2],
            **{name: grad_state[name].numpy() for name in named}}
    got = {"tokens": t.grad, "graph": g.grad, **{name: p.grad for name, p in named.items()}}
    for name, w in want.items():
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=2e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("n, d", [(40, 32), (12, 32)])  # the dense and the subspace route
def test_moment_head_remat_changes_nothing(n, d):
    tokens, graph, _ = _head_inputs(2, n, d, 27)
    results = []
    for remat in (False, True):
        head = MomentHead(d, 16, True, 5, 64, remat=remat).eval()
        init_parameters(head, torch.Generator().manual_seed(0))
        head.reset_sketch(torch.Generator().manual_seed(1))
        t = torch.from_numpy(tokens).requires_grad_()
        g = torch.from_numpy(graph).requires_grad_()
        out = head(t, g)
        torch.sin(out).sum().backward()
        grads = {name: p.grad for name, p in head.named_parameters()}
        results.append((out.detach(), t.grad, g.grad, grads))
    (out0, dt0, dg0, grads0), (out1, dt1, dg1, grads1) = results
    assert torch.equal(out0, out1) and torch.equal(dt0, dt1) and torch.equal(dg0, dg1)
    assert grads0.keys() == grads1.keys()
    assert all(grads0[k] is not None and torch.equal(grads0[k], grads1[k]) for k in grads0)


def test_streamed_gemm_geometry_covers_every_row_and_column():
    for d in range(256, 2049, 256):
        geo = tns.streamed_gemm_geometry(d)
        assert (geo["rows"], geo["cols"], geo["k"]) == (128, 256, 64)
        assert geo["row_blocks"] * geo["rows"] == d and geo["col_blocks"] * geo["cols"] == d
        assert geo["k_tiles"] * geo["k"] == d and (2 * d) % 16 == 0
        # alignment slack, an A tile [128][64] and a B tile [64][256] a stage,
        # a full and an empty barrier a stage
        stages = geo["stages"]
        assert geo["smem"] == 1024 + stages * (128 * 64 * 2 + 64 * 256 * 2) + 16 * stages
        assert stages == 4 and geo["smem"] <= tns.SMEM_LIMIT
    # Swin-Large at 1280: [64, 1536, 1536], 12 x 6 blocks a matrix
    assert tns.streamed_gemm_geometry(1536) == {
        "rows": 128, "row_blocks": 12, "cols": 256, "col_blocks": 6, "k": 64, "k_tiles": 24,
        "stages": 4, "smem": 197696}


def test_streamed_gemm_geometry_refuses_a_ragged_width_on_the_card_path_only():
    for d in range(1, 2049):
        if d % 256:
            with pytest.raises(ValueError, match="multiple of 256"):
                tns.streamed_gemm_geometry(d)
    # the CPU wrapper takes the plain version at any width, 640 too
    m = torch.from_numpy(_spd(1, 640, 24, rank=32))
    assert torch.equal(tns.newton_schulz_isqrt_bf16_streamed_fwd(m, 2, 1e-5),
                       tns.newton_schulz_isqrt_bf16_streamed_plain(m, 2, 1e-5))


def test_bf16_gemm_geometry_pads_every_width_it_takes():
    for d in range(826, 1060):
        geo = tns.bf16_gemm_geometry(d)
        dp = geo["dp"]
        assert dp >= d and dp % 256 == 0 and dp - d < 256
        assert geo == {"dp": dp, "scratch_bytes": 5 * dp * dp * 2,
                       **tns.streamed_gemm_geometry(dp)}
        assert geo["smem"] <= tns.SMEM_LIMIT
    # the model's width pays nothing; the widest runs at 1280
    assert tns.bf16_gemm_geometry(1024)["dp"] == 1024
    assert tns.bf16_gemm_geometry(826)["dp"] == 1024
    assert tns.bf16_gemm_geometry(1059)["dp"] == 1280
    assert tns.bf16_gemm_geometry(1024)["scratch_bytes"] == 5 * 1024 * 1024 * 2


def test_bf16_gemm_geometry_refuses_the_other_widths():
    for d in list(range(1, 826)) + list(range(1060, 2049)):
        with pytest.raises(ValueError, match="826 <= D <= 1059"):
            tns.bf16_gemm_geometry(d)
    # the CPU wrapper takes the plain version at any width, 640 too
    m = torch.from_numpy(_spd(1, 640, 25, rank=32))
    assert torch.equal(tns.newton_schulz_isqrt_bf16_fwd(m, 2, 1e-5),
                       tns.newton_schulz_isqrt_bf16_plain(m, 2, 1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [826, 900, 1059])
def test_bf16_padding_is_exact(d, dtype):
    """Kernel 5′'s recipe on M zero-padded to Dp, as csrc/ns_bf16.cuh runs
    it (Mn = bf16(M_pad / tr) with tr = trace(M) + eps from the unpadded M;
    Y = I on the leading D x D block, zero elsewhere; k steps; the leading
    block rescaled), gives the plain version's bits."""
    m = torch.from_numpy(_spd(1, d, 30 + d, rank=64)).to(dtype)
    dp = tns.bf16_gemm_geometry(d)["dp"]
    padded = torch.zeros(1, dp, dp, dtype=dtype)
    padded[:, :d, :d] = m
    tr = tns._trace(m, 1e-5)[..., None, None]
    mn = tns._bf16(padded.float() / tr)
    y = torch.zeros(1, dp, dp, dtype=torch.bfloat16)
    y[:, :d, :d] = torch.eye(d, dtype=torch.bfloat16)
    for _ in range(5):
        y = tns.bf16_step(y, mn)
    assert not y[:, d:].any() and not y[:, :, d:].any()  # the padding stays zero
    out = (y[:, :d, :d].float() / torch.sqrt(tr)).to(dtype)
    assert torch.equal(out, tns.newton_schulz_isqrt_bf16_plain(m, 5, 1e-5))
