"""The port's training slice against the JAX package, on the CPU in fp32.

swin_micro (two blocks, one of them shifted and downsampled into; N=49 <
D=256), dropout 0, the same flax weights on both sides, the same views made
with numpy.

* the loss dict term by term (1e-5 relative) and every parameter gradient
  against ``jax.value_and_grad`` of the JAX model, laid leaf beside leaf by
  ``flax_tree_from_named_tensors``: per leaf max |diff| <= 2e-4 x max |ref|
  (fp32 sum order through ~12 layers; measured ~1e-5), and 2e-3 for the GPF
  coefficients: the moment head normalizes the fused graph, so each
  ``dc[p, q] = sum(df * A_p * B_q)`` is a sum of large terms that nearly
  cancel (dot Grams reach 1e5 here), and fp32 rounding shows at ~3e-4;
* three whole train steps through ``make_train_step`` (the augmentation
  replaced by fixed views on both sides) against ``value_and_grad`` +
  ``apply_gradients`` with the optax optimizer: losses to 1e-4 relative,
  updated parameters to 1e-5 absolute (bf16 leaf: one bf16 ulp).  The step
  test runs AdamW with eps 1e-6 instead of 1e-8: a gradient that is zero in
  exact arithmetic (a key bias under softmax) is rounding noise of ~1e-9 in
  both frameworks, and eps 1e-8 would turn that noise into updates of full
  size lr with a random sign.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models import create_model as j_create_model
from ego_moment_cle_vit_tpu.train.state import create_train_state as j_create_train_state
from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_train_step
from ego_moment_cle_vit_tpu_torch.data import AugmentConfig
from ego_moment_cle_vit_tpu_torch.train import step as step_module
from ego_moment_cle_vit_tpu_torch.train import step_generators
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

B = 4


def _config(similarity="dot", fusion="add", **moment):
    return {
        "model": {
            "backbone_name": "swin_micro_patch4_window7_56",
            "gpf": {"degree_p": 2, "degree_q": 2, "similarity": similarity},
            "moment": {"d_out": 64, "sketch_dim": 256, "use_third_order": True,
                       "isqrt_iterations": 5, **moment},
            "classifier": {"fusion_type": fusion, "dropout": 0.0},
        },
        "data": {"input_size": 56},
        "training": {
            "optimizer": {"lr": 3e-4, "eps": 1e-6, "factored_threshold": 150_000},
            "scheduler": {"warmup_epochs": 0},
            "loss": {"lambda_triplet": 0.6, "lambda_align": 0.1, "margin": 0.3},
            "epochs": 1,
        },
    }


def _views(seed):
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=(B, 56, 56, 3)).astype(np.float32)
    positive = (anchor + 0.3 * rng.normal(size=anchor.shape)).astype(np.float32)
    labels = np.array([1, 3, 1, 7], np.int32)
    return anchor, positive, labels


def _both_models(cfg, seed=3):
    jm = j_create_model(cfg, num_classes=10)
    dummy = jnp.zeros((1, 56, 56, 3), jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), dummy, dummy)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # coefficients and bias tables away from their init, so their gradients matter
    rng = np.random.default_rng(4)
    variables["params"]["gpf"]["alpha_coeffs"] = rng.normal(size=(3, 3)).astype(np.float32)
    swin = variables["params"]["backbone"]["backbone"]["swin"]
    for name in ("stage0_block0", "stage1_block0"):
        table = swin[name]["attn"]["relative_position_bias_table"]
        swin[name]["attn"]["relative_position_bias_table"] = rng.normal(
            size=table.shape).astype(np.float32) * 0.5
    model = create_model(cfg, num_classes=10, device="cpu")
    model.load_state_dict(torch_state_dict_from_flax(variables, model, device="cpu"))
    return jm, variables, model


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


@pytest.mark.parametrize("similarity, fusion", [("dot", "add"), ("cosine", "concat")])
def test_loss_dict_and_every_gradient_match_jax(similarity, fusion):
    cfg = _config(similarity, fusion)
    jm, variables, model = _both_models(cfg)
    anchor, positive, labels = _views(5)

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
    assert sorted(got) == sorted(ref) and len(ref) > 50
    for path, r in ref.items():
        assert got[path].shape == r.shape, path
        scale = np.abs(r).max()
        assert scale > 0, f"{path}: the reference gradient is all zero"
        tol = 2e-3 if path == "gpf/alpha_coeffs" else 2e-4
        assert np.abs(got[path] - r).max() <= tol * scale, path


def test_zero_loss_weights_drop_their_terms_and_features_are_returned():
    cfg = _config()
    cfg["training"]["loss"] = {"lambda_triplet": 0.0, "lambda_align": 0.0}
    model = create_model(cfg, num_classes=10, device="cpu")
    anchor, positive, labels = (torch.from_numpy(v) for v in _views(6))
    out = model(anchor, positive, labels, return_features=True)
    assert list(out["loss_dict"]) == ["loss_main_ce", "loss_anchor_ce", "loss_positive_ce"]
    feats = out["features"]
    assert feats["anchor_tokens"].shape == (B, 49, 256)
    assert feats["fused_graph"].shape == (B, 49, 49)
    assert feats["moment_features"].shape == (B, 64)
    assert feats["gpf_coefficients"].shape == (3, 3) and (feats["gpf_coefficients"] > 0).all()
    assert "loss" not in model(anchor, positive)
    # ablation_forward: 'full' is the forward's logits, the others their own
    torch.testing.assert_close(model.ablation_forward(anchor, positive), out["logits"],
                               rtol=1e-5, atol=1e-6)
    for mode in ("no_gpf", "uniform_graph", "cls_only"):
        logits = model.ablation_forward(anchor, positive, mode)
        assert logits.shape == (B, 10) and torch.isfinite(logits).all()
        assert not torch.allclose(logits, out["logits"]), mode
    torch.testing.assert_close(model.ablation_forward(anchor, positive, "cls_only"),
                               out["logits_anchor"], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown ablation mode"):
        model.ablation_forward(anchor, positive, "no_moments")


def test_dual_view_backbone_is_one_2b_pass():
    model = create_model(_config(), num_classes=10, device="cpu")
    anchor, positive, _ = (torch.from_numpy(v) for v in _views(7))
    fa, fp = model.backbone(anchor, positive)
    single_a = model.backbone.forward_single(anchor)
    single_p = model.backbone.forward_single(positive)
    for key in ("patch_tokens", "global_features"):
        torch.testing.assert_close(fa[key], single_a[key], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fp[key], single_p[key], rtol=1e-5, atol=1e-5)
        assert fa[key].is_contiguous() and fp[key].is_contiguous()


def test_dropout_follows_the_generator_and_block_remat_changes_nothing():
    cfg = _config()
    cfg["model"]["classifier"]["dropout"] = 0.3
    model = create_model(cfg, num_classes=10, device="cpu", seed=1).train()
    anchor, positive, labels = (torch.from_numpy(v) for v in _views(8))

    def loss(seed):
        return model(anchor, positive, labels,
                     generator=torch.Generator().manual_seed(seed))["loss"].item()

    assert loss(0) == loss(0) and loss(0) != loss(1)
    model.eval()
    assert loss(0) == loss(1)  # no dropout outside training mode

    cfg_remat = _config()
    cfg_remat["model"]["backbone_remat"] = "block"
    plain = create_model(_config(), num_classes=10, device="cpu", seed=2).train()
    remat = create_model(cfg_remat, num_classes=10, device="cpu", seed=2).train()
    grads = []
    for m in (plain, remat):
        m(anchor, positive, labels)["loss"].backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    cfg_bad = _config()
    cfg_bad["model"]["backbone_remat"] = "stage"
    with pytest.raises(ValueError, match="remat"):
        create_model(cfg_bad, num_classes=10, device="cpu")


def test_three_train_steps_match_jax(monkeypatch):
    cfg = _config(bf16_params=True)
    jm, variables, model = _both_models(cfg)
    views = [_views(10 + i) for i in range(3)]

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
    assert tstate.optimizer.factored == ["backbone.backbone.swin.stage1_block0.attn.qkv.weight",
                                         "backbone.backbone.swin.stage1_block0.mlp_fc1.weight",
                                         "backbone.backbone.swin.stage1_block0.mlp_fc2.weight",
                                         "moment_head.second_proj.weight"]
    assert sorted(tstate.optimizer.master) == ["moment_head.second_proj.bias",
                                               "moment_head.second_proj.weight"]
    train_step = make_train_step(model, AugmentConfig(56, 64), device="cpu")
    fed = iter(views)
    monkeypatch.setattr(
        step_module, "dual_view_train_batch",
        lambda images, generator, aug_cfg: tuple(torch.from_numpy(v) for v in next(fed)[:2]))
    seed_gen = torch.Generator().manual_seed(0)
    u8 = torch.zeros(B, 64, 64, 3, dtype=torch.uint8)

    for i, (anchor, positive, labels) in enumerate(views):
        state, ref_loss = j_step(state, jnp.asarray(anchor), jnp.asarray(positive),
                                 jnp.asarray(labels))
        loss = train_step(tstate, u8, torch.from_numpy(labels), seed_gen)
        assert loss.item() == pytest.approx(float(ref_loss), rel=1e-4), f"step {i}"
    assert tstate.step == 3 and tstate.optimizer.count == 3
    assert tstate.optimizer.total_notfinite == 0

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


def test_step_generators_are_a_function_of_seed_and_step():
    g = torch.Generator().manual_seed(11)
    a0, d0 = step_generators(g, 0, torch.device("cpu"))
    a0b, _ = step_generators(g, 0, torch.device("cpu"))
    a1, _ = step_generators(g, 1, torch.device("cpu"))
    other, _ = step_generators(torch.Generator().manual_seed(12), 0, torch.device("cpu"))
    seeds = [x.initial_seed() for x in (a0, d0, a0b, a1, other)]
    assert seeds[0] == seeds[2] and len({seeds[0], seeds[1], seeds[3], seeds[4]}) == 4
    assert g.initial_seed() == 11  # the caller's generator is not advanced or reseeded


def test_train_step_is_reproducible_and_learns():
    cfg = _config()
    cfg["model"]["classifier"]["dropout"] = 0.1
    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (B, 64, 64, 3),
                                                            dtype=np.uint8))
    labels = torch.tensor([1, 3, 1, 7])
    runs = []
    for _ in range(2):
        model = create_model(cfg, num_classes=10, device="cpu", seed=3)
        state = create_train_state(model, cfg, 100, device="cpu")
        step = make_train_step(model, AugmentConfig(56, 64), device="cpu")
        gen = torch.Generator().manual_seed(9)
        runs.append([step(state, u8, labels, gen).item() for _ in range(6)])
    assert runs[0] == runs[1]
    assert all(np.isfinite(runs[0])) and runs[0][-1] < runs[0][0]
    other = create_model(cfg, num_classes=10, device="cpu", seed=3)
    with pytest.raises(ValueError, match="another model"):
        step(create_train_state(other, cfg, 100, device="cpu"), u8, labels, gen)


def test_training_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for machines without one")
    model = create_model(_config(), num_classes=10, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(model, _config(), 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, AugmentConfig(56, 64))
