"""The port's serving path against the JAX package, and its boundaries.

ViT backbones are ported (tests/test_torch_vit.py), and so is the dense
Newton-Schulz route that a ViT whose token count reaches its width takes
(N >= D; tests/test_torch_newton_schulz.py).

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
from ego_moment_cle_vit_tpu_torch.models.moment_head import check_dense_route
from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

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
    {"model": {"gpf": {"adaptive_type": "spatial"}}},
    {"model": {"gpf": {"adaptive_type": "global"}}},
    {"model": {"classifier": {"type": "multiscale"}}},
    {"model": {"classifier": {"type": "adaptive"}}},
    {"model": {"classifier": {"fusion_type": "bilinear"}}},
    {"model": {"norm": "batch"}},
    {"model": {"norm": "none"}},
    {"model": {"moment": {"variant": "simplified"}}},
])
def test_unported_paths_raise(change):
    cfg = _config("dot")
    cfg["data"].update(change.get("data", {}))
    for section, values in change["model"].items():
        if isinstance(values, dict):
            cfg["model"][section] = {**cfg["model"].get(section, {}), **values}
        else:
            cfg["model"][section] = values
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(cfg, num_classes=10, device="cpu")


def test_fused_half_model_serves_like_the_default_mode():
    """``backbone_attn_kernel: fused_half`` builds and serves on the CPU (both
    swin_micro blocks take the fused attention half); on the same weights its
    logits match the default mode's within 1e-4 of max |logit| in fp32 (the
    two differ by sum order and e^-100 terms)."""
    cfg = _config("dot")
    fused = {**cfg, "model": {**cfg["model"], "backbone_attn_kernel": "fused_half"}}
    x = torch.from_numpy(_images(8))
    logits = {}
    for name, c in (("default", cfg), ("fused", fused)):
        model = create_model(c, num_classes=10, device="cpu", seed=5)
        swin = model.backbone.backbone.swin
        assert [swin.stage0_block0.fused, swin.stage1_block0.fused] == [name == "fused"] * 2
        logits[name] = make_infer_fn(model, AugmentConfig(56, 64), device="cpu")(x)
    ref = logits["default"].numpy()
    assert torch.isfinite(logits["fused"]).all()
    np.testing.assert_allclose(logits["fused"].numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_unported_forwards_raise():
    """The dual-view forwards are ported now: with one image as both views they
    give ``inference``'s logits, and the backbone pass gives the single pass's
    features twice.  The dense Newton–Schulz route runs on the CPU; on the
    card it raises only at widths no Newton–Schulz kernel takes."""
    model = create_model(_config("dot"), num_classes=10, device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        out = model(x, x)
        assert sorted(out) == ["logits", "logits_anchor", "logits_positive"]
        torch.testing.assert_close(out["logits"], model.inference(x), rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(out["logits_anchor"], out["logits_positive"], rtol=1e-4,
                                   atol=1e-5)
        anchor_features, positive_features = model.backbone(x, x)
        single = model.backbone.forward_single(x)
        for key in ("patch_tokens", "global_features"):
            torch.testing.assert_close(anchor_features[key], single[key], rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(positive_features[key], single[key], rtol=1e-4, atol=1e-5)
    # the dense Newton–Schulz route (N >= D) runs on the CPU
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.normal(size=(1, 300, 256)).astype(np.float32))
    with torch.no_grad():
        moments = model.moment_head(tokens, torch.ones(1, 300, 300))
    assert moments.shape == (1, model.moment_head.d_out) and torch.isfinite(moments).all()
    check_dense_route(256, "cuda")
    check_dense_route(1024, "cuda")  # kernel 5′
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_dense_route(1100, "cuda")  # no kernel variant takes it


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
    assert len(files) > 20
    names = {str(f.relative_to(pkg)) for f in files[:-1]}
    assert {"losses/triplet.py", "losses/alignment.py", "train/state.py", "train/step.py",
            "models/vit.py", "kernels/packed_attention.py", "data/pipeline.py",
            "data/ufgvc.py", "data/device_cache.py", "train/trainer.py", "train/evaluator.py",
            "utils/port_weights.py", "cli/train.py", "cli/eval.py", "cli/predict.py"} <= names
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in pattern.finditer(f.read_text())]
    assert offenders == []
