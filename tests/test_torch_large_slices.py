"""The slice's two model paths at full width against the JAX package.

ViT-Large/16 at a 512 input (1025 tokens, D = 1024: N = D takes the dense
moment route, kernel 5′ on the card) and Swin-Large at a 1280 input (stage
canvases 320, 160, 80 and 40, padded to 322, 161, 84 and 42 for windows of 7;
the last stage's 1600 tokens >= D = 1536 take the dense route, kernel 5″ on
the card), built by ``create_model`` at full width with the depth cut to one
block per stage (depth is a loop count; every block of a stage has one
geometry), the flagship heads' kinds (dot GPF 2 x 2, the third-order sketch,
the ``add`` classifier) at a narrow ``d_out``, batch 1, fp32 on the CPU.  The
JAX model's weights go through ``torch_state_dict_from_flax``.  Tolerances:
the ViT tokens within 1e-4 of their largest entry (as the converter tests
hold a ViT at 448); logits within 1e-5 of max |logit| (the fp32 slice bar:
sum order through one block per stage, the dense head's five Newton–Schulz
steps on the CPU's fp32 iteration in both frameworks, and the head MLP), and
3e-5 for ViT-Large, whose 1024 unit-scale tokens put the third-order sketch
where the JAX head's fp32 arithmetic loses digits (see
tests/test_torch_newton_schulz_bf16.py, which measures it against fp64): with
the third order off the same logits agree within 1e-5, with it on they read
1.1e-5 to 1.4e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models import create_model as j_create_model
from ego_moment_cle_vit_tpu.models.swin import SWIN_CONFIGS as J_SWIN_CONFIGS
from ego_moment_cle_vit_tpu.models.vit import VIT_CONFIGS as J_VIT_CONFIGS
from ego_moment_cle_vit_tpu_torch import create_model
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as tns
from ego_moment_cle_vit_tpu_torch.models.backbone import (
    backbone_num_features,
    backbone_num_patches,
)
from ego_moment_cle_vit_tpu_torch.models.swin import SWIN_CONFIGS
from ego_moment_cle_vit_tpu_torch.models.vit import VIT_CONFIGS
from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax

# the test workers share the cores: one intra-op thread per worker keeps
# torch's thread pools from contending with each other
torch.set_num_threads(1)

VIT_L, SWIN_L = "vit_large_patch16_224", "swin_large_patch4_window7_224"


def _config(backbone, size):
    return {
        "model": {
            "backbone_name": backbone,
            "gpf": {"degree_p": 2, "degree_q": 2, "similarity": "dot"},
            "moment": {"d_out": 32, "sketch_dim": 256, "use_third_order": True,
                       "isqrt_iterations": 5},
            "classifier": {"fusion_type": "add", "dropout": 0.0},
        },
        "data": {"input_size": size},
    }


def _both_models(cfg, image):
    jm = j_create_model(cfg, num_classes=10)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(image), jnp.asarray(image))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = create_model(cfg, num_classes=10, device="cpu").eval()
    model.load_state_dict(torch_state_dict_from_flax(variables, model, device="cpu"))
    return jm, variables, model


def _jax_logits(jm, variables, image):
    return np.asarray(jax.jit(lambda v, x: jm.apply(v, x, method=jm.inference))(
        variables, jnp.asarray(image)))


def _image(size, seed):
    return np.random.default_rng(seed).normal(size=(1, size, size, 3)).astype(np.float32)


@pytest.fixture
def shallow(monkeypatch):
    """One block per stage in both packages' registries."""
    for registry in (J_VIT_CONFIGS, VIT_CONFIGS):
        monkeypatch.setitem(registry, VIT_L, dataclasses.replace(registry[VIT_L], depth=1))
    for registry in (J_SWIN_CONFIGS, SWIN_CONFIGS):
        monkeypatch.setitem(registry, SWIN_L,
                            dataclasses.replace(registry[SWIN_L], depths=(1, 1, 1, 1)))


def test_vit_large_at_512_matches_jax(shallow):
    assert backbone_num_patches(VIT_L, 512) == backbone_num_features(VIT_L) == 1024
    assert tns.variant_for(1024) == "bf16"
    cfg = _config(VIT_L, 512)
    x = _image(512, 31)
    jm, variables, model = _both_models(cfg, x)
    assert variables["params"]["backbone"]["backbone"]["vit"]["pos_embed"].shape == (1, 1025, 1024)
    ref_tokens = np.asarray(jax.jit(lambda v, i: jm.apply(v, i, method=lambda m, im: (
        m.backbone.forward_single(im, deterministic=True)["patch_tokens"])))(
            variables, jnp.asarray(x)))
    ref = _jax_logits(jm, variables, x)
    with torch.no_grad():
        tokens = model.backbone.forward_single(torch.from_numpy(x))["patch_tokens"].numpy()
        logits = model.inference(torch.from_numpy(x)).numpy()
    assert tokens.shape == ref_tokens.shape == (1, 1024, 1024)
    np.testing.assert_allclose(tokens, ref_tokens, rtol=0, atol=1e-4 * np.abs(ref_tokens).max())
    assert logits.shape == ref.shape == (1, 10) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, ref, rtol=0, atol=3e-5 * np.abs(ref).max())


def test_swin_large_at_1280_matches_jax(shallow):
    assert backbone_num_patches(SWIN_L, 1280) == 1600 >= backbone_num_features(SWIN_L) == 1536
    assert tns.variant_for(1536) == "bf16_streamed"
    cfg = _config(SWIN_L, 1280)
    x = _image(1280, 32)
    jm, variables, model = _both_models(cfg, x)
    swin = model.backbone.backbone.swin
    canvases = [(blk.res[0], blk.hp, blk.attn_mask is not None) for blk in
                (getattr(swin, f"stage{s}_block0") for s in range(4))]
    # every stage pads its canvas, so every block masks the pad sentinel
    assert canvases == [(320, 322, True), (160, 161, True), (80, 84, True), (40, 42, True)]
    ref = _jax_logits(jm, variables, x)
    with torch.no_grad():
        logits = model.inference(torch.from_numpy(x)).numpy()
    assert logits.shape == ref.shape == (1, 10) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
