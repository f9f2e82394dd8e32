"""The port's kernels: plain versions against the Pallas kernels (interpret
mode on the CPU) and the dispatch rules of the wrappers.  The CUDA kernels
against their plain versions on the card are in test_torch_cuda.py.

fp32 throughout on the CPU.  Tolerance 2e-5 absolute for window attention
(outputs are O(1) convex combinations of v; XLA and PyTorch sum the 49-term
products in another order) and, for GPF, 1e-4 of ``gpf_error_scale`` per
entry (fp32 Grams raised to the fourth power by the degree-2x2 polynomial;
the scale holds each entry at its own size, where one scaled by max |G|
would let the dot Gram's diagonal cover every off-diagonal entry).

Backward plain versions: against ``jax.vjp`` of the Pallas functions (fp32;
dqkv 5e-5 absolute, the table gradient 2e-4 absolute, a sum of up to 8 windows
of O(1) terms; GPF token gradients and dcoeffs 1e-4 of their largest entry)
and against ``torch.autograd.grad`` of the forward plain versions in fp64
(1e-9 relative: the same function, differentiated by hand).  The two
``torch.autograd.Function``s pass ``gradcheck`` on the CPU.

Packed-layout attention (the ViT's kernel): ``packed_attention_plain`` /
``packed_attention_bwd_plain`` (from the forward's out and log-sum-exp)
against ``flash_window_attention`` and its ``jax.vjp`` in interpret mode (forward 2e-5 absolute, dqkv 5e-5, dbias 2e-4:
fp32 sum order over up to 197 keys and up to 16 (image, group) pairs), against
fp64 autograd (1e-9 relative) and under ``gradcheck``; GPF at a ViT's 196
tokens against ``fused_gpf_pallas`` as at 49.

The launch protocol (``_build.launch``), on a stand-in wrapper and library:
one ``emct.kernel.<wrapper>`` range under a profiler, the stream appended to
the arguments, one count in ``<wrapper>.launches`` on success, and on a CUDA
error a ``RuntimeError`` naming the wrapper with the count unchanged; a
stand-in put in the wrapper's place takes the count under the wrapper's
span.  The list of libraries, one a ``csrc/*.cu``, holds every source the
benchmark builds, and ``kernel_checks.MAIN_PATH`` names every wrapper.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models.swin import (
    _attn_mask as j_attn_mask,
    _blockdiag_mask,
    _build_bias_bd,
)
from ego_moment_cle_vit_tpu.ops.pallas.gpf import fused_gpf_pallas
from ego_moment_cle_vit_tpu.ops.pallas.window_attention import (
    flash_window_attention,
    flash_window_attention_spatial,
)
from ego_moment_cle_vit_tpu_torch.kernels import _build
from ego_moment_cle_vit_tpu_torch.kernels import gpf as tgpf
from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as tpa
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as twa
from ego_moment_cle_vit_tpu_torch.models.swin import _attn_mask, _relative_position_index
from ego_moment_cle_vit_tpu_torch.ops.graph import gpf_fuse

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

WS = 7


def _port_bias(table: np.ndarray) -> torch.Tensor:
    nt = WS * WS
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1))
    t = torch.from_numpy(table)
    return t[idx].reshape(nt, nt, table.shape[1]).permute(2, 0, 1).contiguous()


# spatial geometry: (Hp = Wp, C, heads, shifted, tile pack, mm pack) as the
# JAX Swin dispatches it (full-row tile, pairs of windows per matmul group)
GEOMETRIES = [(14, 128, 4, True, 2, 2), (14, 128, 4, False, 2, 2), (7, 128, 4, False, 1, 1)]


@pytest.mark.parametrize("hp, c, heads, shifted, pack, mm", GEOMETRIES)
def test_window_attention_plain_matches_pallas(hp, c, heads, shifted, pack, mm):
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(2, hp, hp, 3 * c)).astype(np.float32)
    table = (rng.normal(size=((2 * WS - 1) ** 2, heads)) * 0.5).astype(np.float32)
    mask = _attn_mask(hp, hp, hp, hp, WS, WS // 2) if shifted else None
    assert (mask is not None) == shifted
    scale = (c // heads) ** -0.5

    nt = mm * WS * WS
    bias_bd = _build_bias_bd(jnp.asarray(table), WS, mm, heads)
    jm = j_attn_mask(hp, hp, hp, hp, WS, WS // 2) if shifted else None
    madd = (_blockdiag_mask(jnp.asarray(jm), mm) if jm is not None
            else jnp.zeros((1, nt, nt), jnp.float32))
    ref = flash_window_attention_spatial(jnp.asarray(qkv), bias_bd, madd, heads, WS, pack,
                                         mm, scale)
    out = twa.window_attention_plain(
        torch.from_numpy(qkv), _port_bias(table),
        torch.from_numpy(mask) if mask is not None else None, heads, WS, scale,
    )
    assert out.shape == (2, hp, hp, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_port_mask_is_the_jax_mask():
    np.testing.assert_array_equal(_attn_mask(14, 14, 14, 14, 7, 3),
                                  j_attn_mask(14, 14, 14, 14, 7, 3))
    assert _attn_mask(7, 7, 7, 7, 7, 0) is None


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_gpf_plain_matches_pallas(similarity):
    rng = np.random.default_rng(1)
    ta = rng.normal(size=(2, 49, 64)).astype(np.float32)
    tp = rng.normal(size=(2, 49, 64)).astype(np.float32)
    coeffs = np.log1p(np.exp(rng.uniform(0, 0.1, size=(3, 3)))).astype(np.float32)
    ref = np.asarray(fused_gpf_pallas(jnp.asarray(ta), jnp.asarray(tp), jnp.asarray(coeffs),
                                      similarity, 1e-6, True))
    out = tgpf.gpf_plain(torch.from_numpy(ta), torch.from_numpy(tp),
                         torch.from_numpy(coeffs), similarity, 1e-6, True)
    assert out.dtype == torch.float32 and out.shape == (2, 49, 49)
    scale = tgpf.gpf_error_scale(torch.from_numpy(ta), torch.from_numpy(tp),
                                 torch.from_numpy(coeffs), similarity, 1e-6, True)
    assert (np.abs(out.numpy() - ref) <= 1e-4 * scale.numpy()).all()


def _gram64(t: torch.Tensor, similarity: str) -> torch.Tensor:
    t = t.double()
    if similarity == "cosine":
        t = t / t.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    return t @ t.transpose(1, 2)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("same", [True, False])
def test_gpf_error_scale_holds_each_entry(similarity, same):
    """fp32 is within 2e-4 of the scale of an fp64 reference everywhere, and
    zeroing the off-diagonal entries fails it for nearly every such entry."""
    g = torch.Generator().manual_seed(2)
    ta = torch.randn(4, 49, 256, generator=g)
    tp = ta if same else torch.randn(4, 49, 256, generator=g)
    c = torch.nn.functional.softplus(torch.rand(3, 3, generator=g) * 0.1)
    out = tgpf.gpf_plain(ta, tp, c, similarity)
    ref = gpf_fuse(_gram64(ta, similarity), _gram64(tp, similarity), c.double()).float()
    scale = tgpf.gpf_error_scale(ta, tp, c, similarity)
    assert ((out - ref).abs() <= 2e-4 * scale).all()
    off = ~torch.eye(49, dtype=torch.bool)
    caught = ((out * ~off - ref).abs() > 2e-4 * scale)[:, off]
    nonzero = ref[:, off] > 0  # the clamp leaves about half the distinct-token entries at 0
    assert caught[nonzero].float().mean().item() > 0.99


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(1, 7, 7, 3 * 64, generator=g)
    bias = torch.randn(2, 49, 49, generator=g)
    before = twa.window_attention_fwd.launches
    out = twa.window_attention_fwd(qkv, bias, None, 2, 7, 0.25)
    assert torch.equal(out, twa.window_attention_plain(qkv, bias, None, 2, 7, 0.25))
    assert twa.window_attention_fwd.launches == before  # no kernel launch on the CPU

    t = torch.randn(2, 49, 32, generator=g)
    c = torch.rand(3, 3, generator=g)
    before = tgpf.gpf_fwd.launches
    assert torch.equal(tgpf.gpf_fwd(t, t, c, "dot"), tgpf.gpf_plain(t, t, c, "dot"))
    assert tgpf.gpf_fwd.launches == before


def test_wrappers_raise_on_other_devices():
    """Only CPU tensors take the plain version; nothing else falls back."""
    qkv = torch.empty(1, 7, 7, 96, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        twa.window_attention_fwd(qkv, torch.empty(3, 49, 49, device="meta"), None, 3, 7, 1.0)
    t = torch.empty(1, 49, 32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tgpf.gpf_fwd(t, t, torch.empty(3, 3, device="meta"))


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    from ego_moment_cle_vit_tpu_torch import create_model
    from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax
    from ego_moment_cle_vit_tpu_torch.utils.device import resolve_device

    cfg = {"model": {"backbone_name": "swin_micro_patch4_window7_56"}, "data": {"input_size": 56}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(cfg, num_classes=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_state_dict_from_flax({}, torch.nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _table_bias(table: torch.Tensor, heads: int) -> torch.Tensor:
    nt = WS * WS
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1))
    return table[idx].reshape(nt, nt, heads).permute(2, 0, 1).contiguous()


@pytest.mark.parametrize("hp, c, heads, shifted, pack, mm", GEOMETRIES)
def test_window_attention_bwd_plain_matches_pallas_vjp(hp, c, heads, shifted, pack, mm):
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2, hp, hp, 3 * c)).astype(np.float32)
    dout = rng.normal(size=(2, hp, hp, c)).astype(np.float32)
    table = (rng.normal(size=((2 * WS - 1) ** 2, heads)) * 0.5).astype(np.float32)
    mask = _attn_mask(hp, hp, hp, hp, WS, WS // 2) if shifted else None
    scale = (c // heads) ** -0.5
    nt = mm * WS * WS
    jm = j_attn_mask(hp, hp, hp, hp, WS, WS // 2) if shifted else None
    madd = (_blockdiag_mask(jnp.asarray(jm), mm) if jm is not None
            else jnp.zeros((1, nt, nt), jnp.float32))

    def f(x, t):
        return flash_window_attention_spatial(x, _build_bias_bd(t, WS, mm, heads), madd, heads,
                                              WS, pack, mm, scale)

    _, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(table))
    ref_dqkv, ref_dtable = (np.asarray(x) for x in vjp(jnp.asarray(dout)))

    # the port: the table gradient comes by plain autograd through the gather,
    # dbias from the Function's backward (the plain version on the CPU)
    t_qkv = torch.from_numpy(qkv).requires_grad_()
    t_table = torch.from_numpy(table).requires_grad_()
    t_mask = torch.from_numpy(mask) if mask is not None else None
    out = twa.window_attention(t_qkv, _table_bias(t_table, heads), t_mask, heads, WS, scale)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(t_qkv.grad.numpy(), ref_dqkv, rtol=0, atol=5e-5)
    np.testing.assert_allclose(t_table.grad.numpy(), ref_dtable, rtol=0, atol=2e-4)
    # and the explicit function gives what the Function returned
    dqkv, dbias = twa.window_attention_bwd_plain(
        t_qkv.detach(), _table_bias(t_table.detach(), heads), t_mask, torch.from_numpy(dout),
        heads, WS, scale)
    assert torch.equal(dqkv, t_qkv.grad) and dbias.shape == (heads, 49, 49)


@pytest.mark.parametrize("shifted", [True, False])
def test_window_attention_bwd_plain_matches_autograd_fp64(shifted):
    g = torch.Generator().manual_seed(4)
    hp, c, heads = 14, 64, 2
    qkv = torch.randn(2, hp, hp, 3 * c, generator=g, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(heads, 49, 49, generator=g, dtype=torch.float64, requires_grad=True)
    mask = torch.as_tensor(_attn_mask(hp, hp, hp, hp, WS, 3)).double() if shifted else None
    dout = torch.randn(2, hp, hp, c, generator=g, dtype=torch.float64)
    out = twa.window_attention_plain(qkv, bias, mask, heads, WS, 0.17)
    ref_dqkv, ref_dbias = torch.autograd.grad(out, (qkv, bias), dout)
    dqkv, dbias = twa.window_attention_bwd_plain(qkv.detach(), bias.detach(), mask, dout, heads,
                                                 WS, 0.17)
    torch.testing.assert_close(dqkv, ref_dqkv, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(dbias, ref_dbias, rtol=1e-9, atol=1e-12)
    # a control: without the dK term the same comparison fails
    broken = dqkv.clone()
    broken[..., c:2 * c] = 0
    assert not torch.allclose(broken, ref_dqkv, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_gpf_bwd_plain_matches_pallas_vjp(similarity):
    rng = np.random.default_rng(5)
    ta = rng.normal(size=(2, 49, 64)).astype(np.float32)
    tp = rng.normal(size=(2, 49, 64)).astype(np.float32)
    coeffs = np.log1p(np.exp(rng.uniform(0, 0.1, size=(3, 3)))).astype(np.float32)
    cot = rng.normal(size=(2, 49, 49)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, p, c: fused_gpf_pallas(a, p, c, similarity, 1e-6, True),
                     jnp.asarray(ta), jnp.asarray(tp), jnp.asarray(coeffs))
    ref_da, ref_dp, ref_dc = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    da, dp, dc = tgpf.gpf_bwd_plain(torch.from_numpy(ta), torch.from_numpy(tp),
                                    torch.from_numpy(coeffs), torch.from_numpy(cot), similarity,
                                    1e-6, True)
    assert dc.shape == (2, 3, 3) and dc.dtype == torch.float32
    for out, ref in ((da.numpy(), ref_da), (dp.numpy(), ref_dp), (dc.sum(0).numpy(), ref_dc)):
        assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    # a control: the dR^T half dropped (half the gradient) is far outside
    assert np.abs(0.5 * da.numpy() - ref_da).max() > 1e-2 * np.abs(ref_da).max()


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gpf_bwd_plain_matches_autograd_fp64(similarity, same, symmetric):
    g = torch.Generator().manual_seed(6)
    ta = torch.randn(2, 9, 16, generator=g, dtype=torch.float64, requires_grad=True)
    tp = ta if same else torch.randn(2, 9, 16, generator=g, dtype=torch.float64,
                                     requires_grad=True)
    c = (torch.rand(3, 2, generator=g, dtype=torch.float64) + 0.1).requires_grad_()
    cot = torch.randn(2, 9, 9, generator=g, dtype=torch.float64)
    out = tgpf.gpf_plain(ta, tp, c, similarity, 1e-6, symmetric)
    da, dp, dc = tgpf.gpf_bwd_plain(ta.detach(), tp.detach(), c.detach(), cot, similarity, 1e-6,
                                    symmetric)
    if same:
        ref_t, ref_c = torch.autograd.grad(out, (ta, c), cot)
        torch.testing.assert_close(da + dp, ref_t, rtol=1e-9, atol=1e-12)
    else:
        ref_a, ref_p, ref_c = torch.autograd.grad(out, (ta, tp, c), cot)
        torch.testing.assert_close(da, ref_a, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(dp, ref_p, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(dc.sum(0), ref_c, rtol=1e-9, atol=1e-12)


def test_window_attention_function_gradcheck():
    # 3x3 windows of 8-wide heads keep the numerical Jacobian small; two
    # windows with a 0 / -100 mask
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn(2, 3, 6, 3 * 16, generator=g, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(2, 9, 9, generator=g, dtype=torch.float64, requires_grad=True)
    mask = torch.where(torch.rand(2, 9, 9, generator=g) < 0.2, -100.0, 0.0).double()
    assert torch.autograd.gradcheck(
        lambda a, b: twa.window_attention(a, b, mask, 2, 3, 0.35), (qkv, bias))


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_gpf_function_gradcheck(similarity):
    g = torch.Generator().manual_seed(8)
    ta = torch.randn(2, 7, 12, generator=g, dtype=torch.float64, requires_grad=True)
    tp = torch.randn(2, 7, 12, generator=g, dtype=torch.float64, requires_grad=True)
    c = (torch.rand(3, 3, generator=g, dtype=torch.float64) + 0.1).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b, k: tgpf.gpf(a, b, k, similarity), (ta, tp, c))
    # one tensor as both token sets: the two gradients are added
    assert torch.autograd.gradcheck(lambda a, k: tgpf.gpf(a, a, k, similarity), (ta, c))


def test_backward_wrappers_dispatch_like_the_forward_ones():
    g = torch.Generator().manual_seed(9)
    qkv = torch.randn(1, 7, 7, 3 * 64, generator=g)
    bias = torch.randn(2, 49, 49, generator=g)
    dout = torch.randn(1, 7, 7, 64, generator=g)
    before = twa.window_attention_bwd.launches
    dqkv, dbias = twa.window_attention_bwd(qkv, bias, None, dout, 2, 7, 0.25)
    ref = twa.window_attention_bwd_plain(qkv, bias, None, dout, 2, 7, 0.25)
    assert torch.equal(dqkv, ref[0]) and torch.equal(dbias, ref[1])
    assert twa.window_attention_bwd.launches == before  # no kernel launch on the CPU
    t = torch.randn(2, 49, 32, generator=g)
    c = torch.rand(3, 3, generator=g)
    cot = torch.randn(2, 49, 49, generator=g)
    before = tgpf.gpf_bwd.launches
    out = tgpf.gpf_bwd(t, t, c, cot, "dot")
    assert all(torch.equal(a, b) for a, b in zip(out, tgpf.gpf_bwd_plain(t, t, c, cot, "dot")))
    assert tgpf.gpf_bwd.launches == before
    with pytest.raises(RuntimeError, match="unsupported device"):
        twa.window_attention_bwd(torch.empty(1, 7, 7, 96, device="meta"),
                                 torch.empty(3, 49, 49, device="meta"), None,
                                 torch.empty(1, 7, 7, 32, device="meta"), 3, 7, 1.0)
    m = torch.empty(1, 49, 32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tgpf.gpf_bwd(m, m, torch.empty(3, 3, device="meta"), torch.empty(1, 49, 49, device="meta"))


@pytest.mark.parametrize("batch, blocks", [(128, 256), (128, 32), (5, 4), (1, 1), (7, 400)])
def test_backward_grid_chunks_cover_every_image(batch, blocks):
    n = twa._bwd_chunks(batch, blocks)
    assert 1 <= n <= batch and n * -(-batch // n) >= batch


# packed layout: (B, W, T, C, heads, bias heads or None, mask groups or None).
# The first three are the JAX package's own kernel-test geometries at a smaller
# batch; then the ViT call (one group, 197 tokens, zero bias and mask), a
# head-shared bias with a group-shared mask, and a bias without a mask.
PACKED = [
    (2, 8, 98, 128, 4, 4, 8),
    (1, 2, 98, 512, 16, 16, 2),
    (2, 1, 49, 1024, 32, 32, None),
    (2, 1, 197, 64, 2, None, None),
    (2, 3, 50, 64, 2, 1, 1),
    (1, 2, 17, 64, 1, 1, None),
]


def _packed_inputs(seed, b, w, t, c, heads, hb, wm, dtype=np.float32):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, w, t, 3 * c)).astype(dtype)
    dout = rng.normal(size=(b, w, t, c)).astype(dtype)
    bias = (rng.normal(size=(hb, t, t)) * 0.5).astype(dtype) if hb else None
    mask = (np.where(rng.uniform(size=(wm, t, t)) < 0.2, -100.0, 0.0).astype(dtype)
            if wm else None)
    return qkv, dout, bias, mask


def _jax_packed_args(qkv, bias, mask):
    """The JAX kernel takes zeros where the port takes None."""
    t = qkv.shape[2]
    zeros = jnp.zeros((1, t, t), jnp.float32)
    return (jnp.asarray(qkv), zeros if bias is None else jnp.asarray(bias),
            zeros if mask is None else jnp.asarray(mask))


def _opt(x):
    return torch.from_numpy(x) if x is not None else None


@pytest.mark.parametrize("b, w, t, c, heads, hb, wm", PACKED)
def test_packed_attention_plain_matches_pallas(b, w, t, c, heads, hb, wm):
    qkv, _, bias, mask = _packed_inputs(20, b, w, t, c, heads, hb, wm)
    ref = np.asarray(flash_window_attention(*_jax_packed_args(qkv, bias, mask), heads))
    out = tpa.packed_attention_plain(torch.from_numpy(qkv), _opt(bias), _opt(mask), heads)
    assert out.shape == (b, w, t, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)
    if bias is not None:  # a control: without its bias the same comparison fails
        ctrl = tpa.packed_attention_plain(torch.from_numpy(qkv), None, _opt(mask), heads)
        assert np.abs(ctrl.numpy() - ref).max() > 1e-2


@pytest.mark.parametrize("b, w, t, c, heads, hb, wm", PACKED)
def test_packed_attention_bwd_plain_matches_pallas_vjp(b, w, t, c, heads, hb, wm):
    qkv, dout, bias, mask = _packed_inputs(21, b, w, t, c, heads, hb, wm)
    j_qkv, j_bias, j_mask = _jax_packed_args(qkv, bias, mask)
    _, vjp = jax.vjp(lambda x, bb: flash_window_attention(x, bb, j_mask, heads), j_qkv, j_bias)
    ref_dqkv, ref_dbias = (np.asarray(x) for x in vjp(jnp.asarray(dout)))

    t_qkv = torch.from_numpy(qkv).requires_grad_()
    t_bias = torch.from_numpy(bias).requires_grad_() if bias is not None else None
    out = tpa.packed_attention(t_qkv, t_bias, _opt(mask), heads)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(t_qkv.grad.numpy(), ref_dqkv, rtol=0, atol=5e-5)
    fwd_out, lse = tpa.packed_attention_plain(torch.from_numpy(qkv), _opt(bias), _opt(mask), heads,
                                              return_lse=True)
    dqkv, dbias = tpa.packed_attention_bwd_plain(torch.from_numpy(qkv), _opt(bias), _opt(mask),
                                                 fwd_out, lse, torch.from_numpy(dout), heads)
    assert torch.equal(dqkv, t_qkv.grad)
    if bias is None:
        assert dbias is None
    else:
        assert dbias.shape == bias.shape and torch.equal(dbias, t_bias.grad)
        np.testing.assert_allclose(dbias.numpy(), ref_dbias, rtol=0, atol=2e-4)
        assert np.abs(ref_dbias).max() > 1e-2  # the bias gradient is not trivially zero


@pytest.mark.parametrize("hb, wm", [(2, 3), (1, 1), (None, None), (2, None)])
def test_packed_attention_bwd_plain_matches_autograd_fp64(hb, wm):
    qkv, dout, bias, mask = (x if x is None else torch.from_numpy(x) for x in _packed_inputs(
        22, 2, 3, 11, 32, 2, hb, wm, np.float64))
    qkv.requires_grad_()
    leaves = [qkv]
    if bias is not None:
        leaves.append(bias.requires_grad_())
    out, lse = tpa.packed_attention_plain(qkv, bias, mask, 2, 0.21, return_lse=True)
    refs = torch.autograd.grad(out, leaves, dout)
    dqkv, dbias = tpa.packed_attention_bwd_plain(
        qkv.detach(), None if bias is None else bias.detach(), mask, out.detach(), lse.detach(),
        dout, 2, 0.21)
    torch.testing.assert_close(dqkv, refs[0], rtol=1e-9, atol=1e-12)
    if bias is not None:
        torch.testing.assert_close(dbias, refs[1], rtol=1e-9, atol=1e-12)
    broken = dqkv.clone()
    broken[..., 32:64] = 0  # a control: without dK the same comparison fails
    assert not torch.allclose(broken, refs[0], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("hb", [2, 1, None])
def test_packed_attention_function_gradcheck(hb):
    g = torch.Generator().manual_seed(23)
    qkv = torch.randn(2, 2, 5, 3 * 16, generator=g, dtype=torch.float64, requires_grad=True)
    mask = torch.where(torch.rand(2, 5, 5, generator=g) < 0.2, -100.0, 0.0).double()
    if hb is None:
        assert torch.autograd.gradcheck(
            lambda a: tpa.packed_attention(a, None, mask, 2, 0.3), (qkv,))
        return
    bias = torch.randn(hb, 5, 5, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: tpa.packed_attention(a, b, mask, 2, 0.3), (qkv, bias))


def test_packed_attention_wrappers_dispatch():
    """CPU tensors take the plain versions and count no launch; other devices
    raise; the bias gradient is skipped when nobody asks for it."""
    g = torch.Generator().manual_seed(24)
    qkv = torch.randn(1, 2, 9, 3 * 64, generator=g)
    bias = torch.randn(2, 9, 9, generator=g)
    dout = torch.randn(1, 2, 9, 64, generator=g)
    before = (tpa.packed_attention_fwd.launches, tpa.packed_attention_bwd.launches)
    out = tpa.packed_attention_fwd(qkv, bias, None, 2)
    assert torch.equal(out, tpa.packed_attention_plain(qkv, bias, None, 2))
    out, lse = tpa.packed_attention_fwd(qkv, bias, None, 2, return_lse=True)
    ref_out, ref_lse = tpa.packed_attention_plain(qkv, bias, None, 2, return_lse=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    dqkv, dbias = tpa.packed_attention_bwd(qkv, bias, None, out, lse, dout, 2)
    ref = tpa.packed_attention_bwd_plain(qkv, bias, None, out, lse, dout, 2)
    assert torch.equal(dqkv, ref[0]) and torch.equal(dbias, ref[1])
    assert tpa.packed_attention_bwd(qkv, bias, None, out, lse, dout, 2, need_dbias=False)[1] is None
    assert (tpa.packed_attention_fwd.launches, tpa.packed_attention_bwd.launches) == before
    meta = torch.empty(1, 1, 9, 3 * 64, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tpa.packed_attention_fwd(meta, None, None, 2)
    meta_out = torch.empty(1, 1, 9, 64, device="meta")
    meta_lse = torch.empty(1, 2, 9, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tpa.packed_attention_bwd(meta, None, None, meta_out, meta_lse, meta_out, 2)
    # no gradient can be asked for: the forward wrapper is called directly
    assert tpa.packed_attention(qkv, bias, None, 2).grad_fn is None
    assert tpa.packed_attention(qkv.clone().requires_grad_(), None, None, 2).grad_fn is not None
    assert tpa.kernel_supports(197, 768, 12) and tpa.kernel_supports(197, 192, 3)
    assert not tpa.kernel_supports(785, 768, 12) and not tpa.kernel_supports(197, 96, 2)


@pytest.mark.parametrize("pairs, blocks", [(128, 48), (2048, 16), (5, 4), (1, 1), (7, 4000)])
def test_packed_dbias_chunks_cover_every_pair(pairs, blocks):
    n = tpa._dbias_chunks(pairs, blocks)
    per_chunk = -(-pairs // n)
    assert 1 <= n <= pairs and n * per_chunk >= pairs and (n - 1) * per_chunk < pairs


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
def test_gpf_plain_matches_pallas_at_vit_token_count(similarity):
    """N = 196 tokens, a ViT at 224: forward and VJP against the Pallas kernel."""
    rng = np.random.default_rng(25)
    ta = rng.normal(size=(2, 196, 48)).astype(np.float32)
    tp = rng.normal(size=(2, 196, 48)).astype(np.float32)
    coeffs = np.log1p(np.exp(rng.uniform(0, 0.1, size=(3, 3)))).astype(np.float32)
    cot = rng.normal(size=(2, 196, 196)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, p, c: fused_gpf_pallas(a, p, c, similarity, 1e-6, True),
                       jnp.asarray(ta), jnp.asarray(tp), jnp.asarray(coeffs))
    args = (torch.from_numpy(ta), torch.from_numpy(tp), torch.from_numpy(coeffs))
    out = tgpf.gpf_plain(*args, similarity, 1e-6, True)
    scale = tgpf.gpf_error_scale(*args, similarity, 1e-6, True)
    assert out.shape == (2, 196, 196)
    assert (np.abs(out.numpy() - np.asarray(ref)) <= 1e-4 * scale.numpy()).all()
    ref_da, ref_dp, ref_dc = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    da, dp, dc = tgpf.gpf_bwd_plain(*args, torch.from_numpy(cot), similarity, 1e-6, True)
    for got, want in ((da.numpy(), ref_da), (dp.numpy(), ref_dp), (dc.sum(0).numpy(), ref_dc)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


class _StandInLibrary:
    """A built kernel library's stand-in: its entry point records its
    arguments and returns ``code``."""

    def __init__(self, code: int):
        self.code, self.calls = code, []

    def entry(self, *args):
        self.calls.append(args)
        return self.code

    def emct_error_string(self, code):
        return b"stand-in error"


def _stand_in_kernels(monkeypatch, code: int):
    """A kernel module's stand-in holding one wrapper, ``standin_fwd``, with
    3 launches counted, and a library that returns ``code``."""
    import sys
    import types

    def standin_fwd():
        pass

    standin_fwd.launches = 3
    module = types.ModuleType("standin_kernels")
    module.standin_fwd = standin_fwd
    monkeypatch.setitem(sys.modules, "standin_kernels", module)
    lib = _StandInLibrary(code)
    monkeypatch.setattr(_build, "load", lambda source, signatures: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 4242)
    lib.bound = []
    monkeypatch.setattr(_build, "bind_context", lambda device: lib.bound.append(device))
    return module, lib


def _launched_spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("emct.")]


@pytest.mark.parametrize("code", [0, 700])
def test_launch_protocol(monkeypatch, code):
    """One ``emct.kernel.<wrapper>`` range, the stream after the arguments,
    one count on success; on a CUDA error a ``RuntimeError`` naming the
    wrapper, the count unchanged."""
    module, lib = _stand_in_kernels(monkeypatch, code)

    def run():
        _build.launch("standin_kernels:standin_fwd", "any", {"entry": None},
                      torch.device("cpu"), 7, 0.5)

    if code:
        with pytest.raises(RuntimeError, match="^standin_fwd failed: CUDA error 700 "):
            _launched_spans(run)
    else:
        assert _launched_spans(run) == ["emct.kernel.standin_fwd"]
    assert lib.calls == [(7, 0.5, 4242)] and lib.bound == [torch.device("cpu")]
    assert module.standin_fwd.launches == (3 if code else 4)


def test_bind_context_queries_once_a_thread(monkeypatch):
    """The device's stream is queried (a runtime call, which makes its
    context current) on the first launch of each thread only."""
    import threading

    queries = []

    class Stream:
        def query(self):
            queries.append(threading.get_ident())
            return True

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    monkeypatch.setattr(_build, "_thread", threading.local())
    dev = torch.device("cuda", 0)
    _build.bind_context(dev)
    _build.bind_context(dev)
    t = threading.Thread(target=lambda: [_build.bind_context(dev) for _ in range(2)])
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    _build.bind_context(torch.device("cuda", 1))
    assert len(queries) == 3 and len(set(queries)) == 2


def test_launch_counts_on_what_the_module_name_holds(monkeypatch):
    """A stand-in put in the wrapper's place (a control of the card checks)
    takes the count; the span and the name stay the wrapper's."""
    module, _ = _stand_in_kernels(monkeypatch, 0)
    wrapper = module.standin_fwd

    def truncated():
        pass

    truncated.launches = 0
    module.standin_fwd = truncated
    spans = _launched_spans(lambda: _build.launch("standin_kernels:standin_fwd", "any",
                                                  {"entry": None}, torch.device("cpu")))
    assert spans == ["emct.kernel.standin_fwd"]
    assert truncated.launches == 1 and wrapper.launches == 3


def test_one_library_a_source_and_every_source_the_benchmark_builds():
    import importlib
    from pathlib import Path

    csrc = Path(_build.CSRC_DIR)
    assert _build.KERNEL_SOURCES == tuple(sorted(p.stem for p in csrc.glob("*.cu")))
    assert len(_build.KERNEL_SOURCES) == len(_build.wrappers()) == 15
    work = Path(__file__).resolve().parent.parent / "h100_bench" / "kernel_work"
    for path in sorted(work.glob("[!_]*.py")):
        mod = importlib.import_module(f"h100_bench.kernel_work.{path.stem}")
        assert mod.SOURCE in _build.KERNEL_SOURCES, path.name
        assert mod.WRAPPER.split(":")[1] == path.stem in _build.wrappers(), path.name


def test_main_path_calls_name_every_wrapper():
    """``chip_smoke.py`` runs each wrapper's card check at these calls, in
    bf16: every wrapper has one at least."""
    import kernel_checks

    assert set(kernel_checks.MAIN_PATH) == set(_build.wrappers())
    for name, (check, cases) in kernel_checks.MAIN_PATH.items():
        assert cases and callable(check), name
        assert all(torch.bfloat16 in case or check is kernel_checks.check_swiglu_norm_fwd
                   for case in cases), name
