"""The port's kernels: plain versions against the Pallas kernels (interpret
mode on the CPU) and the dispatch rules of the wrappers.  The CUDA kernels
against their plain versions on the card are in test_torch_cuda.py.

fp32 throughout on the CPU.  Tolerance 2e-5 absolute for window attention
(outputs are O(1) convex combinations of v; XLA and PyTorch sum the 49-term
products in another order) and, for GPF, 1e-4 of ``gpf_error_scale`` per
entry (fp32 Grams raised to the fourth power by the degree-2x2 polynomial;
the scale holds each entry at its own size, where one scaled by max |G|
would let the dot Gram's diagonal cover every off-diagonal entry).
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
from ego_moment_cle_vit_tpu.ops.pallas.window_attention import flash_window_attention_spatial
from ego_moment_cle_vit_tpu_torch.kernels import gpf as tgpf
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as twa
from ego_moment_cle_vit_tpu_torch.models.swin import _attn_mask, _relative_position_index
from ego_moment_cle_vit_tpu_torch.ops.graph import gpf_fuse

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
