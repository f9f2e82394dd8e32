"""Kernel 2b (the GPF backward) on the CPU: the bf16 dX kernel's launch
geometry, the precision of its split product, and its plain version against
the JAX package.

* ``gpf.bwd_geometry``, which the wrapper passes to ``csrc/gpf_bwd_sm90.cuh``
  and the C side checks, for every N in 1..1700 at the widths the models and
  the card tests use: the row and feature blocks cover every row, token and
  feature, the W rows' pitch keeps every TMA row and plane stride on the
  16-byte grain, the token maps are used exactly where their rows keep it,
  and a block fits an H100's shared memory.
* The split product, emulated in plain PyTorch: W rebuilt in fp32 from
  ``gpf_bwd_plain``'s formulas, ``W_hi = bf16(W)``, ``W_lo = bf16(W - W_hi)``,
  ``dX = W_hi X + W_lo X`` with fp32 sums (every product of two bf16 values
  is exact in fp32), then the cosine fold.  At batch 1 and the main paths'
  shapes (784 x 768, 1024 x 1024), bf16 tokens, dot and cosine, it is held
  to an fp64 autograd evaluation of the same function within 1e-4 of each
  row's largest entry (they read 5.5e-6 to 9.8e-6: W's own fp32 rounding
  and the Grams' decide it); one bf16 W, the control, must be at least 10x
  further off (it reads 3.6e-3 to 6.0e-3: a bf16 W costs the gradient three
  digits).
  The cotangent is zeroed where the pre-activation lies within 1e-4 of its
  error scale of zero, since on the clamp's kink fp32 and fp64 may take
  different branches.
* ``gpf_bwd_plain`` against ``jax.vjp`` of ``fused_gpf_pallas`` (interpret
  mode) past one 64-token tile and at a width TMA cannot take (N = 65, D =
  100): token gradients and dcoeffs within 1e-4 of their largest entry.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.ops.pallas.gpf import fused_gpf_pallas
from ego_moment_cle_vit_tpu_torch.kernels import gpf as tgpf
from ego_moment_cle_vit_tpu_torch.ops.graph import gpf_fuse, token_similarity_graph

# the test workers share the cores: one intra-op thread per worker keeps
# torch's thread pools from contending with each other
torch.set_num_threads(1)

WIDTHS = (64, 100, 192, 768, 1024, 1536)


@pytest.mark.parametrize("d", WIDTHS)
def test_bwd_geometry_covers_every_row_token_and_feature(d):
    for n in range(1, 1701):
        geo = tgpf.bwd_geometry(n, d)
        rows, cols, k = geo["rows"], geo["cols"], geo["k"]
        assert (rows, cols, k) == (tgpf.BWD_ROWS, tgpf.BWD_COLS, tgpf.BWD_K) == (128, 256, 64)
        assert (geo["row_blocks"] - 1) * rows < n <= geo["row_blocks"] * rows
        assert (geo["col_blocks"] - 1) * cols < d <= geo["col_blocks"] * cols
        assert (geo["k_tiles"] - 1) * k < n <= geo["k_tiles"] * k
        # W_hi / W_lo rows: the TMA row stride and plane stride on 16 bytes,
        # the padding under one 16-byte chunk
        pitch = geo["pitch"]
        assert n <= pitch < n + 8 and (2 * pitch) % 16 == 0 and (2 * pitch * n) % 16 == 0
        # the lo plane starts 16-byte aligned after B hi planes of both sets
        assert all((2 * b * 2 * n * pitch) % 16 == 0 for b in (1, 3, 64))
        # the token maps only where a token row is a multiple of 16 bytes
        assert geo["tma_tokens"] == ((2 * d) % 16 == 0)


@pytest.mark.parametrize("d", WIDTHS)
def test_bwd_geometry_fits_one_block_an_sm(d):
    for n in (1, 49, 64, 65, 196, 784, 785, 1024, 1600, 1700):
        geo = tgpf.bwd_geometry(n, d)
        stages = geo["stages"]
        # alignment slack, W_hi and W_lo [128][64] and tokens [64][256] a
        # stage, a full and an empty barrier a stage
        assert geo["smem"] == 1024 + stages * (2 * 128 * 64 * 2 + 64 * 256 * 2) + 16 * stages
        assert stages == 3 and geo["smem"] <= tgpf.SMEM_LIMIT


def test_bwd_geometry_at_the_main_path_shapes():
    # ViT-Base/448: N = 784 tokens of 768; ViT-Large/512: 1024 of 1024
    assert tgpf.bwd_geometry(784, 768) == {
        "rows": 128, "row_blocks": 7, "cols": 256, "col_blocks": 3, "k": 64, "k_tiles": 13,
        "pitch": 784, "tma_tokens": True, "stages": 3, "smem": 197680}
    assert tgpf.bwd_geometry(1024, 1024) == {
        "rows": 128, "row_blocks": 8, "cols": 256, "col_blocks": 4, "k": 64, "k_tiles": 16,
        "pitch": 1024, "tma_tokens": True, "stages": 3, "smem": 197680}
    # Swin-Base/224: 49 tokens, pitch 56; ViT-Base/224: 196, pitch 200
    assert tgpf.bwd_geometry(49, 1024)["pitch"] == 56
    assert tgpf.bwd_geometry(196, 768)["pitch"] == 200


def _factor(ta, tp, coeffs, g, similarity, eps=1e-6):
    """W = S / (m m^T), proj = rowsum(S R), m and the gate, per token set, in
    fp32 from gpf_bwd_plain's formulas (symmetrized), as the w kernel forms
    them."""
    a, p_ = ta.float(), tp.float()
    c = coeffs.float()
    if similarity == "cosine":
        ma = a.norm(dim=-1, keepdim=True)
        mp = p_.norm(dim=-1, keepdim=True)
        gates = ((ma > eps).float(), (mp > eps).float())
        ma, mp = ma.clamp(min=eps), mp.clamp(min=eps)
    else:
        ma = mp = torch.ones(*a.shape[:-1], 1)
        gates = (torch.ones_like(ma), torch.ones_like(mp))
    r_a = (a / ma) @ (a / ma).transpose(-1, -2)
    r_p = (p_ / mp) @ (p_ / mp).transpose(-1, -2)

    def powers(r, degree):
        rc = r.clamp(min=0.0)
        vals, grads, rc_pow = [torch.ones_like(r)], [torch.zeros_like(r)], torch.ones_like(r)
        for k in range(1, degree + 1):
            vals.append(r * rc_pow)
            grads.append(k * rc_pow)
            rc_pow = rc_pow * rc
        return vals, grads

    av, ag = powers(r_a, c.shape[0] - 1)
    bv, bg = powers(r_p, c.shape[1] - 1)
    fused = sum(c[p, q] * av[p] * bv[q] for p in range(c.shape[0]) for q in range(c.shape[1]))
    fused = 0.5 * (fused + fused.transpose(-1, -2))
    df = g * (fused > 0.0).float()
    df = 0.5 * (df + df.transpose(-1, -2))
    dra = sum(df * c[p, q] * ag[p] * bv[q] for p in range(c.shape[0]) for q in range(c.shape[1]))
    drp = sum(df * c[p, q] * av[p] * bg[q] for p in range(c.shape[0]) for q in range(c.shape[1]))
    out = []
    for dr, r, m, gate in ((dra, r_a, ma, gates[0]), (drp, r_p, mp, gates[1])):
        s = dr + dr.transpose(-1, -2)
        out.append((s / (m * m.transpose(-1, -2)), (s * r).sum(-1, keepdim=True), m, gate))
    return out


def _dx(w, proj, m, gate, x, cosine, split):
    """dX = W X (split: W_hi X + W_lo X; else one bf16 W) with fp32 sums, then
    the cosine fold dx_i -= gate_i proj_i / m_i^2 x_i."""
    xf = x.float()
    hi = w.to(torch.bfloat16).float()
    dx = hi @ xf
    if split:
        dx = dx + (w - hi).to(torch.bfloat16).float() @ xf
    if cosine:
        dx = dx - gate * proj / (m * m) * xf
    return dx


def _rows_error(out, ref):
    """Largest |out - ref| over each row's largest |ref|."""
    scale = ref.abs().amax(dim=-1, keepdim=True)
    return float(((out.double() - ref) / scale).abs().max())


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("n, d", [(784, 768), (1024, 1024)])
def test_split_product_holds_the_gradient_to_fp64(n, d, similarity):
    g = torch.Generator().manual_seed(40 + n)
    ta = torch.randn(1, n, d, generator=g).to(torch.bfloat16)
    tp = torch.randn(1, n, d, generator=g).to(torch.bfloat16)
    coeffs = torch.nn.functional.softplus(torch.rand(3, 3, generator=g) * 0.1)
    cot = torch.randn(1, n, n, generator=g, dtype=torch.float64)
    # the reference: autograd of the fused GPF in fp64 on the same bf16 tokens
    a64 = ta.double().requires_grad_()
    p64 = tp.double().requires_grad_()
    pre = gpf_fuse(token_similarity_graph(a64.detach(), similarity, 1e-6),
                   token_similarity_graph(p64.detach(), similarity, 1e-6), coeffs.double(),
                   symmetric_enforce=True, clamp=False)
    band = 1e-4 * tgpf.gpf_error_scale(ta.double(), tp.double(), coeffs, similarity, 1e-6, True)
    cot = torch.where(pre.abs() <= band.double(), torch.zeros_like(cot), cot)
    out = tgpf.gpf_plain(a64, p64, coeffs.double(), similarity, 1e-6, True)
    ref_a, ref_p = torch.autograd.grad(out, (a64, p64), cot)
    cosine = similarity == "cosine"
    errors, controls = [], []
    for (w, proj, m, gate), x, ref in zip(_factor(ta, tp, coeffs, cot.float(), similarity),
                                          (ta, tp), (ref_a, ref_p)):
        errors.append(_rows_error(_dx(w, proj, m, gate, x, cosine, True), ref))
        controls.append(_rows_error(_dx(w, proj, m, gate, x, cosine, False), ref))
    assert max(errors) <= 1e-4, errors
    assert min(controls) >= 10 * max(errors), (errors, controls)


def test_gpf_bwd_plain_matches_pallas_vjp_past_one_tile():
    rng = np.random.default_rng(41)
    ta = rng.normal(size=(2, 65, 100)).astype(np.float32)
    tp = rng.normal(size=(2, 65, 100)).astype(np.float32)
    coeffs = np.log1p(np.exp(rng.uniform(0, 0.1, size=(3, 3)))).astype(np.float32)
    cot = rng.normal(size=(2, 65, 65)).astype(np.float32)
    for similarity in ("dot", "cosine"):
        _, vjp = jax.vjp(lambda a, p, c: fused_gpf_pallas(a, p, c, similarity, 1e-6, True),
                         jnp.asarray(ta), jnp.asarray(tp), jnp.asarray(coeffs))
        ref_da, ref_dp, ref_dc = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
        da, dp, dc = tgpf.gpf_bwd_plain(torch.from_numpy(ta), torch.from_numpy(tp),
                                        torch.from_numpy(coeffs), torch.from_numpy(cot),
                                        similarity, 1e-6, True)
        for out, ref in ((da.numpy(), ref_da), (dp.numpy(), ref_dp), (dc.sum(0).numpy(), ref_dc)):
            assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
        # a control: the dR^T half dropped (half the gradient) is far outside
        assert np.abs(0.5 * da.numpy() - ref_da).max() > 1e-2 * np.abs(ref_da).max()
