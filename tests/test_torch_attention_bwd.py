"""The attention backward from the forward's log-sum-exp (kernels 3b and 6b).

The packed forward's plain version returns each row's log-sum-exp, and the
backward's plain version rebuilds the probabilities from it and takes
delta = rowsum(dout * out); here both are held against the JAX package:
``flash_window_attention`` and its ``jax.vjp`` with the Pallas kernels in
interpret mode (fp32 on the CPU, numpy inputs from a seed), with and without
bias and mask, at 1, 49, 65 and 197 tokens.  Tolerances: lse 1e-12 relative
in fp64 against ``torch.logsumexp`` of the logits (the same function); dqkv
5e-5 and dbias 2e-4 absolute against the VJP, as
``tests/test_torch_kernels.py`` holds the packed backward (fp32 sum order over
up to 197 keys and 4 (image, group) pairs).  ``PackedAttentionFunction``,
which now saves (qkv, bias, mask, out, lse), passes an fp64 gradcheck.  The
launch geometry the CUDA wrappers pass to the Hopper kernels is checked for
every T in 1..1100 at both head widths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.ops.pallas.window_attention import flash_window_attention
from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as tpa

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)


def _inputs(seed, b, w, t, c, heads, bias, mask, dtype=np.float32):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, w, t, 3 * c)).astype(dtype)
    dout = rng.normal(size=(b, w, t, c)).astype(dtype)
    bias = (rng.normal(size=(heads, t, t)) * 0.5).astype(dtype) if bias else None
    mask = (np.where(rng.uniform(size=(w, t, t)) < 0.2, -100.0, 0.0).astype(dtype)
            if mask else None)
    return qkv, dout, bias, mask


def _opt(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("bias, mask", [(False, False), (True, True)])
@pytest.mark.parametrize("t", [1, 49, 197])
def test_plain_lse_is_each_rows_log_sum_exp(t, bias, mask):
    qkv, _, b_, m_ = _inputs(0, 2, 2, t, 32, 2, bias, mask, np.float64)
    out, lse = tpa.packed_attention_plain(torch.from_numpy(qkv), _opt(b_), _opt(m_), 2, 0.3,
                                          return_lse=True)
    assert lse.shape == (4, 2, t) and lse.dtype == torch.float64
    x = torch.from_numpy(qkv).reshape(2, 2, t, 3, 2, 16)
    logits = torch.einsum("bwihd,bwjhd->bwhij", x[..., 0, :, :], x[..., 1, :, :]) * 0.3
    if b_ is not None:
        logits = logits + torch.from_numpy(b_)[None, None]
    if m_ is not None:
        logits = logits + torch.from_numpy(m_)[None, :, None]
    ref = torch.logsumexp(logits, dim=-1).reshape(4, 2, t)
    torch.testing.assert_close(lse, ref, rtol=1e-12, atol=1e-12)
    # asking for lse changes nothing else
    assert torch.equal(out, tpa.packed_attention_plain(torch.from_numpy(qkv), _opt(b_), _opt(m_),
                                                       2, 0.3))


@pytest.mark.parametrize("bias, mask", [(False, False), (True, False), (False, True),
                                        (True, True)])
@pytest.mark.parametrize("t", [1, 49, 65, 197])
def test_plain_backward_from_lse_matches_pallas_vjp(t, bias, mask):
    heads, c = 2, 128
    qkv, dout, b_, m_ = _inputs(1, 2, 2, t, c, heads, bias, mask)
    zeros = jnp.zeros((1, t, t), jnp.float32)
    j_bias = zeros if b_ is None else jnp.asarray(b_)
    j_mask = zeros if m_ is None else jnp.asarray(m_)
    _, vjp = jax.vjp(lambda x, bb: flash_window_attention(x, bb, j_mask, heads, interpret=True),
                     jnp.asarray(qkv), j_bias)
    ref_dqkv, ref_dbias = (np.asarray(x) for x in vjp(jnp.asarray(dout)))
    out, lse = tpa.packed_attention_plain(torch.from_numpy(qkv), _opt(b_), _opt(m_), heads,
                                          return_lse=True)
    dqkv, dbias = tpa.packed_attention_bwd_plain(torch.from_numpy(qkv), _opt(b_), _opt(m_), out,
                                                 lse, torch.from_numpy(dout), heads)
    np.testing.assert_allclose(dqkv.numpy(), ref_dqkv, rtol=0, atol=5e-5)
    if b_ is None:
        assert dbias is None
    else:
        np.testing.assert_allclose(dbias.numpy(), ref_dbias, rtol=0, atol=2e-4)
    broken = dqkv.numpy().copy()
    broken[..., c:2 * c] = 0  # a control: dK zeroed falls outside (one token: dK is zero)
    assert t == 1 or np.abs(broken - ref_dqkv).max() > 5e-5


@pytest.mark.parametrize("bias, mask", [(True, True), (False, False)])
def test_function_gradcheck_with_saved_out_and_lse(bias, mask):
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn(2, 2, 7, 3 * 16, generator=g, dtype=torch.float64, requires_grad=True)
    m_ = torch.where(torch.rand(2, 7, 7, generator=g) < 0.2, -100.0, 0.0).double() if mask else None
    if not bias:
        assert torch.autograd.gradcheck(lambda a: tpa.packed_attention(a, None, m_, 2, 0.3), (qkv,))
        return
    b_ = torch.randn(2, 7, 7, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, bb: tpa.packed_attention(a, bb, m_, 2, 0.3),
                                    (qkv, b_))


def test_function_saves_out_and_lse():
    """The backward starts from the forward's own out and lse: what autograd
    gives equals the plain backward from them."""
    qkv, dout, b_, m_ = (_opt(x) for x in _inputs(3, 1, 2, 9, 64, 2, True, True))
    x = qkv.clone().requires_grad_()
    bb = b_.clone().requires_grad_()
    tpa.packed_attention(x, bb, m_, 2).backward(dout)
    out, lse = tpa.packed_attention_plain(qkv, b_, m_, 2, return_lse=True)
    dqkv, dbias = tpa.packed_attention_bwd_plain(qkv, b_, m_, out, lse, dout, 2)
    assert torch.equal(x.grad, dqkv) and torch.equal(bb.grad, dbias)


@pytest.mark.parametrize("head_dim", tpa.HEAD_DIMS)
def test_bwd_geometry_fits_and_covers_every_row_and_key(head_dim):
    """For every T in 1..1100: two blocks fit an SM's shared memory (228 KB,
    1 KB of it reserved a block) and each a block's 227 KB; the row blocks
    cover every row of the owned axis and start below T; the walked tiles
    cover every key or query, the last one non-empty and read to a multiple of
    16 that wgmma takes."""
    for t in range(1, 1101):
        geo = tpa.bwd_geometry(t, head_dim)
        assert geo["smem"] <= tpa.SMEM_LIMIT and 2 * (geo["smem"] + 1024) <= 233472
        rows = geo["rows"]
        assert (geo["row_blocks"] - 1) * rows < t <= geo["row_blocks"] * rows
        walk, tile, last = geo["walk_tiles"], geo["tile"], geo["last"]
        assert last in (16, 32, 48, 64) and last <= tile
        assert (walk - 1) * tile < t <= (walk - 1) * tile + last
        assert (walk - 1) * tile + last - t < 16  # at most 15 padded columns
        assert 2 <= geo["stages"] <= 8
        tile_bytes = tile * head_dim * 2
        assert geo["smem"] >= 1024 + tile_bytes * (2 + 2 * geo["stages"])


def test_bwd_geometry_at_the_main_path_shapes():
    # ViT-Base/224: 197 tokens walk 208 columns (3 tiles and one of 16), not 256
    assert tpa.bwd_geometry(197, 64) == {"row_blocks": 4, "rows": 64, "walk_tiles": 4,
                                         "tile": 64, "last": 16, "stages": 3, "smem": 68152}
    assert tpa.bwd_geometry(785, 64)["last"] == 32  # ViT-Base/448: 800 columns
    assert tpa.bwd_geometry(1025, 64)["row_blocks"] == 17  # ViT-Large/512
