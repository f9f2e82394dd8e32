"""The port's ViT backbone and the whole model on a ViT, against the JAX package.

fp32 on the CPU, numpy inputs from a seed, the same flax weights on both sides.

* A 2-block, D = 128, 4-head ViT at 64 x 64 (T = 17 tokens) against
  ``models/vit.py`` with ``attn_kernel='off'`` (XLA path) and ``'on'`` (the
  Pallas kernel in interpret mode): tokens within 1e-4 of the largest, every
  parameter gradient of ``sum(sin(tokens))`` within 2e-4 of its leaf's largest
  entry (fp32 sum order through two blocks; measured ~1e-6).
* The whole model on ``vit_micro_patch16_64`` (N = 16 < D = 64, the subspace
  iSQRT route): loss dict term by term (1e-5 relative), every parameter
  gradient against ``jax.value_and_grad`` (2e-4 of the leaf's largest entry,
  2e-3 for the GPF coefficients, whose gradient is a near-cancelling sum), and
  three whole train steps against ``apply_gradients`` with the optax chain
  (losses 1e-4 relative, parameters 1e-5 absolute), which also shows that
  ``cls_token`` and ``pos_embed`` are decayed as the JAX chain decays them.
  AdamW runs with eps 1e-6 for the reason given in test_torch_training.py.
* The same on the long-sequence path: ``vit_micro_patch16_64`` at a 288
  input gives T = 325 tokens, past the packed kernel, so the port takes
  ``flash_attention_tiled`` (kernel 6's path) and the JAX model, run with
  ``backbone_attn_kernel: 'on'``, its q-tiled Pallas kernel in interpret mode;
  and N = 324 >= D = 64, so both heads take the dense Newton–Schulz route
  (kernel 5's path; XLA's iteration on the JAX side).  Same tolerances.
* The fp64 build of the same model (``create_model(dtype=torch.float64)``),
  the rounding-free reference the card holds the GPF coefficients' gradient
  to: every module's output and every leaf in fp64, the loss the fp32
  model's within 1e-6 relative, and that gradient through ``gradcheck`` at
  1e-9 absolute (its entries are 5e-8 to 7e-5), which fp32 rounding anywhere
  on its path would fail.
* The registry, the converter's round trip and its carry of a ViT-Base at
  448 (``pos_embed [1, 785, 768]``, tokens within 1e-4 of the largest), the
  attention dispatch, and the shapes on the dense route.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models import create_model as j_create_model
from ego_moment_cle_vit_tpu.models.backbone import backbone_num_patches as j_num_patches
from ego_moment_cle_vit_tpu.models.vit import VIT_CONFIGS as J_VIT_CONFIGS
from ego_moment_cle_vit_tpu.models.vit import ViT as JViT
from ego_moment_cle_vit_tpu.models.vit import ViTConfig as JViTConfig
from ego_moment_cle_vit_tpu.models.vit import _resolve_attn_path as j_resolve_attn_path
from ego_moment_cle_vit_tpu.train.state import create_train_state as j_create_train_state
from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_train_step
from ego_moment_cle_vit_tpu_torch.data import AugmentConfig
from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as tfa
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as tns
from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as tpa
from ego_moment_cle_vit_tpu_torch.models.backbone import (
    CLEViTBackbone,
    backbone_num_features,
    backbone_num_patches,
)
from ego_moment_cle_vit_tpu_torch.models.layers import init_parameters
from ego_moment_cle_vit_tpu_torch.models.moment_head import check_dense_route
from ego_moment_cle_vit_tpu_torch.models.vit import VIT_CONFIGS, ViT, ViTConfig, resolve_attn_path
from ego_moment_cle_vit_tpu_torch.train import step as step_module
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

KW = dict(img_size=64, embed_dim=128, depth=2, num_heads=4)
B = 4
LONG = 288  # vit_micro at this input: 1 + 18 * 18 = 325 tokens, N = 324 >= D = 64


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_vit():
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    params = JViT(JViTConfig(attn_kernel="off", **KW)).init(jax.random.PRNGKey(1), jnp.asarray(x))
    # every leaf away from its init (LayerNorm ones / zeros, zero biases), so
    # the conversion of each matters
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(2)
    leaves = [np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32) for l in leaves]
    return x, jax.tree_util.tree_unflatten(tree, leaves)


@pytest.fixture(scope="module")
def port_vit(jax_vit):
    _, params = jax_vit
    model = ViT(ViTConfig(**KW), dtype=torch.float32, device="cpu").eval()
    model.load_state_dict(torch_state_dict_from_flax(params, model, device="cpu"))
    return model


@pytest.mark.parametrize("attn_kernel", ["off", "on"])
def test_vit_matches_jax(jax_vit, port_vit, attn_kernel):
    x, params = jax_vit
    jm = JViT(JViTConfig(attn_kernel=attn_kernel, **KW))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = port_vit(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 17, 128)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("attn_kernel", ["off", "on"])
def test_vit_every_gradient_matches_jax(jax_vit, port_vit, attn_kernel):
    x, params = jax_vit
    jm = JViT(JViTConfig(attn_kernel=attn_kernel, **KW))
    ref = _flat(jax.tree_util.tree_map(
        np.asarray, jax.grad(lambda p: jnp.sum(jnp.sin(jm.apply(p, jnp.asarray(x)))))(params)
    )["params"])
    port_vit.zero_grad(set_to_none=True)
    torch.sin(port_vit(torch.from_numpy(x))).sum().backward()
    grads = {n: p.grad.numpy() for n, p in port_vit.named_parameters()}
    got = _flat(flax_tree_from_named_tensors(grads, port_vit)["params"])
    assert sorted(got) == sorted(ref) and len(ref) == 2 + 2 + 2 * 12 + 2
    for path, r in ref.items():
        assert got[path].shape == r.shape, path
        assert np.abs(r).max() > 0, f"{path}: the reference gradient is all zero"
        assert np.abs(got[path] - r).max() <= 2e-4 * np.abs(r).max(), path


def test_converter_layouts_and_round_trip(jax_vit, port_vit):
    _, params = jax_vit
    p = params["params"]
    sd = port_vit.state_dict()
    np.testing.assert_array_equal(sd["cls_token"].numpy(), np.asarray(p["cls_token"]))
    np.testing.assert_array_equal(sd["pos_embed"].numpy(), np.asarray(p["pos_embed"]))
    np.testing.assert_array_equal(sd["blocks_1.mlp.fc1.weight"].numpy(),
                                  np.asarray(p["blocks_1"]["mlp"]["fc1"]["kernel"]).T)
    np.testing.assert_array_equal(sd["patch_embed.proj.weight"].numpy(),
                                  np.asarray(p["patch_embed"]["proj"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["norm.weight"].numpy(), np.asarray(p["norm"]["scale"]))
    # and back: the port's tensors laid out as the flax tree are the flax tree
    named = {n: t.detach().numpy() for n, t in port_vit.named_parameters()}
    back = _flat(flax_tree_from_named_tensors(named, port_vit)["params"])
    ref = _flat(jax.tree_util.tree_map(np.asarray, p))
    assert sorted(back) == sorted(ref)
    for path, r in ref.items():
        np.testing.assert_array_equal(back[path], r, err_msg=path)


def test_converter_raises_on_missing_and_stray_leaves(jax_vit, port_vit):
    _, params = jax_vit
    p = {k: v for k, v in params["params"].items() if k != "pos_embed"}
    with pytest.raises(KeyError, match="without a flax leaf.*pos_embed"):
        torch_state_dict_from_flax({"params": p}, port_vit, device="cpu")
    extra = dict(params["params"], dist_token=np.zeros((1, 1, 128), np.float32))
    with pytest.raises(KeyError, match="dist_token"):
        torch_state_dict_from_flax({"params": extra}, port_vit, device="cpu")


def test_registry_is_the_jax_registry():
    assert sorted(VIT_CONFIGS) == sorted(J_VIT_CONFIGS)
    for name, cfg in VIT_CONFIGS.items():
        ref = J_VIT_CONFIGS[name]
        for field in ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio",
                      "layer_norm_eps"):
            assert getattr(cfg, field) == getattr(ref, field), (name, field)
        assert backbone_num_features(name) == ref.embed_dim
        for size in (None, 224, 448):
            assert backbone_num_patches(name, size) == j_num_patches(name, size)
    assert backbone_num_patches("swin_base_patch4_window7_224") == 49
    with pytest.raises(ValueError, match="Unknown backbone"):
        backbone_num_patches("resnet50")


@pytest.mark.parametrize("name", sorted(VIT_CONFIGS))
def test_every_registered_vit_builds_and_runs_at_reduced_depth(name):
    """Full width, registered input size, two blocks (depth is a loop count):
    token 0 is the global feature, the rest are contiguous-able patch tokens."""
    cfg = dataclasses.replace(VIT_CONFIGS[name], depth=2)
    vit = ViT(cfg, device="cpu")
    init_parameters(vit, torch.Generator().manual_seed(0))
    assert vit.cls_token.abs().max() > 0 and vit.pos_embed.abs().max() > 0
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, cfg.img_size, cfg.img_size, 3)).astype(np.float32))
    with torch.no_grad():
        tokens = vit(x)
    assert tokens.shape == (1, 1 + cfg.num_patches, cfg.embed_dim)
    assert torch.isfinite(tokens).all()
    with pytest.raises(ValueError, match="position embedding"):
        vit(x[:, :32, :32])


def test_backbone_splits_cls_from_patches():
    bb = CLEViTBackbone("vit_micro_patch16_64", device="cpu")
    init_parameters(bb, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        feats = bb(x)
        tokens = bb.vit(x)
    assert bb.num_prefix_tokens == 1 and bb.num_features == 64
    assert torch.equal(feats["global_features"], tokens[:, 0])
    assert torch.equal(feats["patch_tokens"], tokens[:, 1:])
    bigger = CLEViTBackbone("vit_micro_patch16_64", img_size=96, device="cpu")
    assert bigger.vit.pos_embed.shape == (1, 1 + 36, 64)
    with pytest.raises(ValueError, match="Unknown backbone"):
        CLEViTBackbone("vit_huge_patch14_224", device="cpu")


# ----------------------------------------------------------------------------
# the whole model on a ViT
# ----------------------------------------------------------------------------


def _config(similarity="dot", fusion="add", size=64, attn_kernel="auto", **moment):
    return {
        "model": {
            "backbone_name": "vit_micro_patch16_64",
            "backbone_attn_kernel": attn_kernel,
            "gpf": {"degree_p": 2, "degree_q": 2, "similarity": similarity},
            "moment": {"d_out": 64, "sketch_dim": 256, "use_third_order": True,
                       "isqrt_iterations": 5, **moment},
            "classifier": {"fusion_type": fusion, "dropout": 0.0},
        },
        "data": {"input_size": size},
        "training": {
            "optimizer": {"lr": 3e-4, "eps": 1e-6, "factored_threshold": 150_000},
            "scheduler": {"warmup_epochs": 0},
            "loss": {"lambda_triplet": 0.6, "lambda_align": 0.1, "margin": 0.3},
            "epochs": 1,
        },
    }


def _views(seed, size=64):
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=(B, size, size, 3)).astype(np.float32)
    positive = (anchor + 0.3 * rng.normal(size=anchor.shape)).astype(np.float32)
    labels = np.array([1, 3, 1, 7], np.int32)
    return anchor, positive, labels


def _both_models(cfg, seed=3):
    jm = j_create_model(cfg, num_classes=10)
    size = cfg["data"]["input_size"]
    dummy = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), dummy, dummy)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(4)
    variables["params"]["gpf"]["alpha_coeffs"] = rng.normal(size=(3, 3)).astype(np.float32)
    model = create_model(cfg, num_classes=10, device="cpu")
    model.load_state_dict(torch_state_dict_from_flax(variables, model, device="cpu"))
    return jm, variables, model


@pytest.fixture
def long_path_spies(monkeypatch):
    """Counts the calls of the q-tiled attention and Newton–Schulz wrappers
    (the CPU takes their plain versions, so their launch counters stay)."""
    calls = {"flash_attention_tiled_fwd": 0, "newton_schulz_isqrt_fwd": 0}
    for module, name in ((tfa, "flash_attention_tiled_fwd"), (tns, "newton_schulz_isqrt_fwd")):
        def spy(*args, _fn=getattr(module, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("similarity, fusion", [("dot", "add"), ("cosine", "concat")])
def test_vit_model_loss_dict_and_every_gradient_match_jax(similarity, fusion):
    _check_loss_dict_and_every_gradient(_config(similarity, fusion), 64)


def test_long_sequence_dense_route_model_loss_dict_and_every_gradient_match_jax(
        long_path_spies):
    """vit_micro at 288: the port's blocks take the q-tiled attention and its
    head the dense route; the JAX blocks run the tiled Pallas kernel."""
    cfg = _config(size=LONG, attn_kernel="on")
    assert j_resolve_attn_path("on", 325, 64, 2) == "tiled"
    _check_loss_dict_and_every_gradient(cfg, LONG)
    assert long_path_spies == {"flash_attention_tiled_fwd": 2, "newton_schulz_isqrt_fwd": 1}


def _check_loss_dict_and_every_gradient(cfg, size):
    jm, variables, model = _both_models(cfg)
    anchor, positive, labels = _views(5, size)

    def loss_fn(params):
        out = jm.apply({"params": params, "constants": variables["constants"]},
                       jnp.asarray(anchor), jnp.asarray(positive), jnp.asarray(labels),
                       deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return out["loss"], out["loss_dict"]

    (ref_loss, ref_dict), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    model.train()
    out = model(torch.from_numpy(anchor), torch.from_numpy(positive), torch.from_numpy(labels))
    assert list(out["loss_dict"]) == ["loss_main_ce", "loss_anchor_ce", "loss_positive_ce",
                                      "loss_triplet", "loss_align"]
    for key, value in out["loss_dict"].items():
        assert value.item() == pytest.approx(float(ref_dict[key]), rel=1e-5, abs=1e-7), key
    assert out["loss"].item() == pytest.approx(float(ref_loss), rel=1e-5)
    out["loss"].backward()

    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    got = _flat(flax_tree_from_named_tensors(grads, model)["params"])
    ref = _flat(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert sorted(got) == sorted(ref) and len(ref) > 40
    assert "backbone/backbone/vit/cls_token" in ref and "backbone/backbone/vit/pos_embed" in ref
    for path, r in ref.items():
        assert got[path].shape == r.shape, path
        scale = np.abs(r).max()
        assert scale > 0, f"{path}: the reference gradient is all zero"
        tol = 2e-3 if path == "gpf/alpha_coeffs" else 2e-4
        assert np.abs(got[path] - r).max() <= tol * scale, path


def test_vit_model_three_train_steps_match_jax(monkeypatch):
    _check_three_train_steps(monkeypatch, _config(bf16_params=True), 64)


def test_long_sequence_dense_route_model_three_train_steps_match_jax(monkeypatch,
                                                                    long_path_spies):
    _check_three_train_steps(monkeypatch, _config(size=LONG, attn_kernel="on",
                                                  bf16_params=True), LONG)
    assert long_path_spies == {"flash_attention_tiled_fwd": 6, "newton_schulz_isqrt_fwd": 3}


def _check_three_train_steps(monkeypatch, cfg, size):
    jm, variables, model = _both_models(cfg)
    views = [_views(10 + i, size) for i in range(3)]
    state = j_create_train_state(jm, jax.tree_util.tree_map(jnp.asarray, variables), cfg, 100)

    @jax.jit
    def j_step(state, anchor, positive, labels):
        def loss_fn(params):
            return jm.apply({"params": params, "constants": state.constants}, anchor, positive,
                            labels, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)})["loss"]

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    tstate = create_train_state(model, cfg, 100, device="cpu")
    train_step = make_train_step(model, AugmentConfig(size, size + 8), device="cpu")
    fed = iter(views)
    monkeypatch.setattr(
        step_module, "dual_view_train_batch",
        lambda images, generator, aug_cfg: tuple(torch.from_numpy(v) for v in next(fed)[:2]))
    seed_gen = torch.Generator().manual_seed(0)
    u8 = torch.zeros(B, size + 8, size + 8, 3, dtype=torch.uint8)
    for i, (anchor, positive, labels) in enumerate(views):
        state, ref_loss = j_step(state, jnp.asarray(anchor), jnp.asarray(positive),
                                 jnp.asarray(labels))
        loss = train_step(tstate, u8, torch.from_numpy(labels), seed_gen)
        assert loss.item() == pytest.approx(float(ref_loss), rel=1e-4), f"step {i}"
    assert tstate.step == 3 and tstate.optimizer.total_notfinite == 0

    named = {n: p.detach().float().numpy() for n, p in model.named_parameters()}
    got = _flat(flax_tree_from_named_tensors(named, model)["params"])
    ref = _flat(jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)),
                                       state.params))
    start = _flat(variables["params"])
    assert sorted(got) == sorted(ref)
    moved = 0
    for path, r in ref.items():
        if "second_proj" in path:
            np.testing.assert_allclose(got[path], r, rtol=2.0**-7, atol=1e-5, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-5, err_msg=path)
        moved += int(np.abs(r - start[path].astype(np.float32)).max() > 1e-4)
    assert moved > 0.9 * len(ref)  # the steps really moved the parameters
    for leaf in ("cls_token", "pos_embed"):  # fp32 leaves, decayed and updated like the rest
        path = f"backbone/backbone/vit/{leaf}"
        assert np.abs(ref[path] - start[path]).max() > 1e-4


def test_fp64_model_keeps_fp64_throughout_and_passes_gradcheck_on_the_gpf_coefficients():
    cfg = _config(size=LONG)
    model32 = create_model(cfg, num_classes=10, device="cpu", seed=3)
    model = create_model(cfg, num_classes=10, device="cpu", seed=3, dtype=torch.float64)
    model.load_state_dict(model32.state_dict())
    leaves = [*model.parameters(), *model.buffers()]
    assert {t.dtype for t in leaves if t.is_floating_point()} == {torch.float64}
    anchor, positive, labels = (torch.from_numpy(v) for v in _views(5, LONG))

    narrow = []

    def record(module, args, out):
        stack = [out]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (tuple, list)):
                stack.extend(x)
            elif isinstance(x, torch.Tensor) and x.is_floating_point() and x.dtype != torch.float64:
                narrow.append(type(module).__name__)

    hooks = [m.register_forward_hook(record) for m in model.modules()]
    out = model(anchor.double(), positive.double(), labels)
    for h in hooks:
        h.remove()
    assert narrow == [] and out["loss"].dtype == torch.float64
    out["loss"].backward()
    assert all(p.grad.dtype == torch.float64 for p in model.parameters())
    ref = model32(anchor, positive, labels)["loss"].item()
    assert out["loss"].item() == pytest.approx(ref, rel=1e-6)

    def loss(coeffs):
        return torch.func.functional_call(model, {"gpf.alpha_coeffs": coeffs},
                                          (anchor.double(), positive.double(), labels))["loss"]

    coeffs = model.gpf.alpha_coeffs.detach().clone().requires_grad_()
    assert torch.autograd.gradcheck(loss, (coeffs,), atol=1e-9, rtol=1e-6)


def test_vit_model_serves_trains_and_block_remat_changes_nothing():
    cfg = _config()
    cfg["model"]["classifier"]["dropout"] = 0.1
    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (B, 72, 72, 3),
                                                            dtype=np.uint8))
    labels = torch.tensor([1, 3, 1, 7])
    model = create_model(cfg, num_classes=10, device="cpu", seed=3)
    state = create_train_state(model, cfg, 100, device="cpu")
    step = make_train_step(model, AugmentConfig(64, 72), device="cpu")
    gen = torch.Generator().manual_seed(9)
    losses = [step(state, u8, labels, gen).item() for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]

    anchor, positive, lab = (torch.from_numpy(v) for v in _views(8))
    cfg_remat = _config()
    cfg_remat["model"]["backbone_remat"] = "block"
    grads = []
    for c in (_config(), cfg_remat):
        m = create_model(c, num_classes=10, device="cpu", seed=2).train()
        m(anchor, positive, lab)["loss"].backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    # one image as both views gives inference's logits; patch tokens are contiguous
    m.eval()
    with torch.no_grad():
        torch.testing.assert_close(m(anchor, anchor)["logits"], m.inference(anchor), rtol=1e-4,
                                   atol=1e-5)
        fa, fp = m.backbone(anchor, positive)
        assert fa["patch_tokens"].is_contiguous() and fp["patch_tokens"].shape == (B, 16, 64)
        assert m.backbone.forward_single(anchor)["patch_tokens"].is_contiguous()


@pytest.mark.parametrize("name, size", [("vit_tiny_patch16_224", 224),
                                        ("vit_base_patch16_224", 448),
                                        ("deit_tiny_patch16_224", None)])
def test_vit_shapes_on_the_dense_route_build_and_serve(monkeypatch, long_path_spies, name, size):
    """N >= D takes the moment head's dense Newton–Schulz route: full width,
    one block (depth is a loop count), one image through ``inference``.  At
    448 the 785 tokens also take the q-tiled attention."""
    monkeypatch.setitem(VIT_CONFIGS, name, dataclasses.replace(VIT_CONFIGS[name], depth=1))
    cfg = {"model": {"backbone_name": name, "moment": {"d_out": 32, "sketch_dim": 64}},
           "data": {"input_size": size}}
    model = create_model(cfg, num_classes=10, device="cpu")
    s = size or 224
    assert backbone_num_patches(name, size) >= backbone_num_features(name)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, s, s, 3)).astype(np.float32))
    with torch.no_grad():
        logits = model.inference(x)
    assert logits.shape == (1, 10) and torch.isfinite(logits).all()
    assert long_path_spies == {"flash_attention_tiled_fwd": 1 if s == 448 else 0,
                               "newton_schulz_isqrt_fwd": 1}


def test_long_sequences_take_the_tiled_kernel(long_path_spies):
    """Past the packed kernel's 256 tokens a CUDA tensor is dispatched to
    ``flash_attention_tiled`` (checked through the rule the module applies);
    the CPU takes the same path with the plain versions, which agree with the
    packed plain version on the same function."""
    assert resolve_attn_path(785, 768, 12, "cuda") == "tiled"  # ViT-Base at 448
    assert resolve_attn_path(785, 1024, 16, torch.device("cuda")) == "tiled"  # ViT-Large
    assert resolve_attn_path(197, 768, 12, "cuda") == "packed"  # ViT-Base at 224
    assert resolve_attn_path(tpa.MAX_TOKENS + 1, 192, 3, "cuda") == "tiled"
    with pytest.raises(NotImplementedError, match="heads of neither"):
        resolve_attn_path(785, 96, 2, "cuda")  # heads of 48 are not compiled
    assert resolve_attn_path(785, 96, 2, "cpu") == "tiled"
    assert resolve_attn_path(197, 96, 2, "cpu") == "packed"
    vit = ViT(ViTConfig(img_size=448, embed_dim=64, depth=1, num_heads=2), device="cpu")
    init_parameters(vit, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 448, 448, 3)).astype(np.float32))
    with torch.no_grad():
        assert vit(x).shape == (1, 785, 64)
    assert long_path_spies["flash_attention_tiled_fwd"] == 1


@pytest.mark.parametrize("size", [224, 448, 512])
def test_dense_route_past_the_fp32_kernel_raises_on_the_card_only(size):
    """Every registered ViT at a common input: on the dense route (N >= D) the
    card takes the fp32 kernel's widths and, past them, the bf16 variant's
    (ViT-Large at 512: N = D = 1024, kernel 5′), as the CPU does; a width no
    variant takes raises on the card, naming ROADMAP."""
    dense = []
    for name in sorted(VIT_CONFIGS):
        d = backbone_num_features(name)
        if backbone_num_patches(name, size) < d:
            continue
        dense.append(name)
        check_dense_route(d, "cpu")
        check_dense_route(d, "cuda")
        assert tns.variant_for(d) == ("fp32" if d <= 825 else "bf16")
    assert ("vit_base_patch16_224" in dense) == (size >= 448)
    assert ("vit_large_patch16_224" in dense) == (size >= 512)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_dense_route(1100, "cuda")


def test_converter_carries_a_vit_at_448():
    """ViT-Base width at a 448 input: the position embedding is [1, 785, 768],
    and the converted port ViT gives the JAX ViT's tokens (one block)."""
    kw = dict(img_size=448, embed_dim=768, depth=1, num_heads=12)
    jm = JViT(JViTConfig(attn_kernel="off", **kw))
    x = np.random.default_rng(8).normal(size=(1, 448, 448, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(
        lambda a: (0.02 * rng.normal(size=a.shape)).astype(np.float32), shapes)
    assert params["params"]["pos_embed"].shape == (1, 785, 768)
    vit = ViT(ViTConfig(**kw), device="cpu").eval()
    vit.load_state_dict(torch_state_dict_from_flax(params, vit, device="cpu"))
    np.testing.assert_array_equal(vit.pos_embed.detach().numpy(), params["params"]["pos_embed"])
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = vit(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 785, 768)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
