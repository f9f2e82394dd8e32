"""The port's serving path against the JAX package, and its boundaries.

``make_infer_fn`` of the port (uint8 -> eval preprocess -> Swin -> fused GPF
-> moment head -> classifier) against the JAX ``bench_core.make_infer_fn``
with the same flax weights and sketch matrices, on swin_micro (N=49 < D=256,
so the token-subspace iSQRT route runs), fp32 on the CPU.  Logits tolerance:
1e-4 relative to max |logit|, for ~15 layers of fp32 sum-order differences
(measured agreement is ~2e-6).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.bench_core import make_infer_fn as j_make_infer_fn
from ego_moment_cle_vit_tpu.data import AugmentConfig as JAugmentConfig
from ego_moment_cle_vit_tpu.data import dual_view_eval_batch as j_eval_batch
from ego_moment_cle_vit_tpu.models import create_model as j_create_model
from ego_moment_cle_vit_tpu_torch import create_model, make_infer_fn
from ego_moment_cle_vit_tpu_torch.data import AugmentConfig, dual_view_eval_batch
from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax

REPO = pathlib.Path(__file__).resolve().parent.parent


def _config(similarity, fusion="add"):
    return {
        "model": {
            "backbone_name": "swin_micro_patch4_window7_56",
            "gpf": {"degree_p": 2, "degree_q": 2, "similarity": similarity},
            "moment": {"d_out": 64, "sketch_dim": 256, "use_third_order": True,
                       "isqrt_iterations": 5},
            "classifier": {"fusion_type": fusion},
        },
        "data": {"input_size": 56},
    }


def _images(seed=0, b=2, s=64):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3), dtype=np.uint8)


def test_dual_view_eval_batch_matches_jax():
    u8 = _images(1)
    ref_a, ref_p = j_eval_batch(jnp.asarray(u8), JAugmentConfig(input_size=56, resize_size=64))
    a, p = dual_view_eval_batch(torch.from_numpy(u8), AugmentConfig(input_size=56, resize_size=64))
    assert a.shape == (2, 56, 56, 3) and a.dtype == torch.float32 and p is a
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), rtol=0, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-6)


@pytest.mark.parametrize("similarity, fusion", [("dot", "add"), ("cosine", "add"),
                                                ("dot", "concat")])
def test_serving_matches_jax(similarity, fusion):
    cfg = _config(similarity, fusion)
    jm = j_create_model(cfg, num_classes=10)
    dummy = jnp.zeros((1, 56, 56, 3), jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), dummy, dummy)
    # GPF coefficients away from their init, so their conversion matters
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["params"]["gpf"]["alpha_coeffs"] = np.random.default_rng(4).normal(
        size=(3, 3)).astype(np.float32)
    u8 = _images(2)
    aug = dict(input_size=56, resize_size=64)
    ref = np.asarray(j_make_infer_fn(jm, JAugmentConfig(**aug))(variables, jnp.asarray(u8)))

    model = create_model(cfg, num_classes=10, device="cpu")
    model.load_state_dict(torch_state_dict_from_flax(variables, model, device="cpu"))
    out = make_infer_fn(model, AugmentConfig(**aug), device="cpu")(torch.from_numpy(u8))
    assert out.shape == ref.shape == (2, 10)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_fresh_model_is_seeded_and_finite():
    cfg = _config("dot")
    infer_a = make_infer_fn(create_model(cfg, 10, device="cpu", seed=5), AugmentConfig(56, 64),
                            device="cpu")
    infer_b = make_infer_fn(create_model(cfg, 10, device="cpu", seed=5), AugmentConfig(56, 64),
                            device="cpu")
    x = torch.from_numpy(_images(3))
    a, b = infer_a(x), infer_b(x)
    assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("change", [
    {"model": {"backbone_name": "vit_small_patch16_224"}},
    {"model": {"gpf": {"adaptive_type": "global"}}},
    {"model": {"classifier": {"type": "multiscale"}}},
    {"model": {"classifier": {"type": "adaptive"}}},
    {"model": {"classifier": {"fusion_type": "bilinear"}}},
    {"model": {"norm": "batch"}},
    {"model": {"norm": "none"}},
    {"model": {"moment": {"variant": "simplified"}}},
    {"model": {"backbone_attn_kernel": "fused_half"}},
])
def test_unported_paths_raise(change):
    cfg = _config("dot")
    for section, values in change["model"].items():
        if isinstance(values, dict):
            cfg["model"][section] = {**cfg["model"].get(section, {}), **values}
        else:
            cfg["model"][section] = values
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(cfg, num_classes=10, device="cpu")


def test_unported_forwards_raise():
    model = create_model(_config("dot"), num_classes=10, device="cpu")
    x = torch.zeros(1, 56, 56, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(x, x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.backbone(x, x)
    # the dense Newton–Schulz route (N >= D) is not ported
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.moment_head(torch.zeros(1, 300, 256), torch.ones(1, 300, 300))


def test_port_imports_no_jax():
    """The port package and chip_smoke.py import neither JAX nor the JAX package."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b|\bego_moment_cle_vit_tpu\.|"
        r"^\s*(import|from)\s+ego_moment_cle_vit_tpu\b(?!_torch)",
        re.M,
    )
    pkg = REPO / "ego_moment_cle_vit_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py") if "_build" not in f.relative_to(pkg).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in pattern.finditer(f.read_text())]
    assert offenders == []
