"""The port's Swin against the JAX Swin with converted weights.

Two stages of depth 2 at 56x56 input: stage 0 runs an unshifted block and a
SHIFTED, masked block at 14x14 tokens (the registered swin_micro has depth 1
per stage and never shifts); stage 1 runs at 7x7, where shift is disabled.
The JAX side runs both its XLA path ('off') and its spatial Pallas kernel in
interpret mode ('spatial').  fp32 on the CPU; tolerance 1e-4 absolute on
LayerNorm-scaled tokens, for four blocks of fp32 sum-order differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models.swin import Swin as JSwin
from ego_moment_cle_vit_tpu.models.swin import SwinConfig as JSwinConfig
from ego_moment_cle_vit_tpu.models.swin import _build_bias_bd
from ego_moment_cle_vit_tpu_torch.models.swin import Swin, SwinConfig
from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax

KW = dict(img_size=56, embed_dim=128, depths=(2, 2), num_heads=(4, 8))


@pytest.fixture(scope="module")
def jax_swin():
    x = np.random.default_rng(0).normal(size=(2, 56, 56, 3)).astype(np.float32)
    params = JSwin(JSwinConfig(**KW)).init(jax.random.PRNGKey(1), jnp.asarray(x))
    # perturb LayerNorm scales/biases and the bias tables away from their
    # init so the conversion of every leaf matters
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(2)
    leaves = [np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32) for l in leaves]
    return x, jax.tree_util.tree_unflatten(tree, leaves)


@pytest.fixture(scope="module")
def port_swin(jax_swin):
    _, params = jax_swin
    model = Swin(SwinConfig(**KW), dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(torch_state_dict_from_flax(params, model, device="cpu"))
    return model


def test_geometry_has_a_shifted_masked_block(port_swin):
    blk = port_swin.stage0_block1
    assert blk.shift == 3 and blk.attn_mask is not None and blk.attn_mask.shape == (4, 49, 49)
    assert port_swin.stage1_block1.shift == 0 and port_swin.stage1_block1.attn_mask is None


@pytest.mark.parametrize("attn_kernel", ["off", "spatial"])
def test_swin_matches_jax(jax_swin, port_swin, attn_kernel):
    x, params = jax_swin
    ref = np.asarray(JSwin(JSwinConfig(attn_kernel=attn_kernel, **KW)).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = port_swin(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 49, 256)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("block", ["stage0_block0", "stage1_block1"])
def test_relative_position_bias_gather_matches_one_hot(jax_swin, port_swin, block):
    _, params = jax_swin
    table = params["params"][block]["attn"]["relative_position_bias_table"]
    ref = np.asarray(_build_bias_bd(jnp.asarray(table), 7, 1, table.shape[1]))
    out = getattr(port_swin, block).relative_position_bias().detach().numpy()
    np.testing.assert_array_equal(out, ref)


def test_converter_layouts(jax_swin, port_swin):
    _, params = jax_swin
    p = params["params"]
    sd = port_swin.state_dict()
    np.testing.assert_array_equal(sd["stage0_block0.attn.qkv.weight"].numpy(),
                                  np.asarray(p["stage0_block0"]["attn"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["patch_embed_proj.weight"].numpy(),
        np.asarray(p["patch_embed_proj"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["norm.weight"].numpy(), np.asarray(p["norm"]["scale"]))


def test_converter_raises_on_missing_and_unused_keys(jax_swin, port_swin):
    _, params = jax_swin
    p = {k: v for k, v in params["params"].items() if k != "norm"}
    with pytest.raises(KeyError, match="without a flax leaf.*norm.weight"):
        torch_state_dict_from_flax({"params": p}, port_swin, device="cpu")
    extra = dict(params["params"], extra_layer={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra_layer"):
        torch_state_dict_from_flax({"params": extra}, port_swin, device="cpu")
