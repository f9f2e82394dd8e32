"""The port's q-tiled attention (kernel 6, 6b) against the JAX package.

fp32 on the CPU, numpy inputs from a seed.  ``flash_attention_tiled_plain``
and ``flash_attention_tiled_bwd_plain`` against ``flash_attention_tiled`` of
the JAX package and its ``jax.vjp``, the Pallas kernels run in interpret mode
as ``tests/test_pallas_kernels.py`` runs them, at 300 and 325 tokens (the
sequence pads to 384 keys and three query tiles there) and two heads of 32
and of 64.  Tolerances: forward 2e-5 absolute and dqkv 2e-4 absolute, as the
JAX package holds its kernel against plain attention: fp32 sum order over up
to 325 keys.  ``FlashAttentionTiledFunction`` passes ``gradcheck`` in fp64,
and the plain versions equal the packed-attention ones where both apply (the
same function, 1e-12 in fp64).  The CUDA kernels against these plain
versions are in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.ops.pallas.flash_attention import (
    flash_attention_tiled as j_flash_attention_tiled,
)
from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as tfa
from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as tpa

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

SHAPES = [(300, 32), (300, 64), (325, 32), (325, 64)]  # (tokens, head width), two heads


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((2, t, 3 * 2 * d)).astype(np.float32)
    dout = rng.standard_normal((2, t, 2 * d)).astype(np.float32)
    return qkv, dout


@pytest.mark.parametrize("t, d", SHAPES)
def test_plain_forward_matches_jax(t, d):
    qkv, _ = _inputs(t, d, 0)
    ref = np.asarray(j_flash_attention_tiled(jnp.asarray(qkv), 2, interpret=True))
    out, lse = tfa.flash_attention_tiled_plain(torch.from_numpy(qkv), 2)
    assert out.shape == (2, t, 2 * d) and lse.shape == (2, 2, t)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("t, d", SHAPES)
def test_plain_backward_matches_jax_vjp(t, d):
    qkv, dout = _inputs(t, d, 1)
    _, vjp = jax.vjp(lambda x: j_flash_attention_tiled(x, 2, interpret=True), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(dout))
    got = tfa.flash_attention_tiled_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(dout), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-4)
    # and autograd through the Function takes the same plain backward on the CPU
    x = torch.from_numpy(qkv).requires_grad_()
    tfa.flash_attention_tiled(x, 2).backward(torch.from_numpy(dout))
    assert torch.equal(x.grad, got)


def test_lse_is_each_rows_log_sum_exp():
    qkv = torch.from_numpy(_inputs(130, 32, 2)[0]).double()
    _, lse = tfa.flash_attention_tiled_plain(qkv, 2)
    q, k = qkv[..., :64].reshape(2, 130, 2, 32), qkv[..., 64:128].reshape(2, 130, 2, 32)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * 32 ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("t", [17, 197, 256])
def test_plain_versions_equal_packed_attention_where_both_apply(t):
    qkv, dout = (torch.from_numpy(x).double() for x in _inputs(t, 32, 3))
    out, _ = tfa.flash_attention_tiled_plain(qkv, 2)
    ref = tpa.packed_attention_plain(qkv[:, None], None, None, 2)[:, 0]
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)
    dq = tfa.flash_attention_tiled_bwd_plain(qkv, dout, 2)
    out4, lse = tpa.packed_attention_plain(qkv[:, None], None, None, 2, return_lse=True)
    ref_dq, _ = tpa.packed_attention_bwd_plain(qkv[:, None], None, None, out4, lse, dout[:, None],
                                               2)
    torch.testing.assert_close(dq, ref_dq[:, 0], rtol=1e-12, atol=1e-12)


def test_function_gradcheck_fp64():
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((1, 20, 3 * 16))).requires_grad_()
    assert torch.autograd.gradcheck(lambda x: tfa.flash_attention_tiled(x, 2), (qkv,))


def test_kernel_supports_any_length_at_compiled_head_widths():
    assert tfa.kernel_supports(785, 768, 12)  # ViT-Base at 448
    assert tfa.kernel_supports(785, 1024, 16)  # ViT-Large at 448
    assert tfa.kernel_supports(4097, 64, 2)
    assert not tfa.kernel_supports(785, 96, 2)  # heads of 48 are not compiled
    assert not tfa.kernel_supports(785, 100, 3)
    assert not tfa.kernel_supports(0, 64, 2)


def test_wrappers_take_the_plain_versions_on_the_cpu_without_counting():
    qkv, dout = (torch.from_numpy(x) for x in _inputs(40, 32, 5))
    before = (tfa.flash_attention_tiled_fwd.launches, tfa.flash_attention_tiled_bwd.launches)
    out, lse = tfa.flash_attention_tiled_fwd(qkv, 2)
    dq = tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, 2)
    assert torch.equal(out, tfa.flash_attention_tiled_plain(qkv, 2)[0])
    assert torch.equal(dq, tfa.flash_attention_tiled_bwd_plain(qkv, dout, 2))
    assert (tfa.flash_attention_tiled_fwd.launches,
            tfa.flash_attention_tiled_bwd.launches) == before
