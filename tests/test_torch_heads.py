"""The port's head options against the JAX package's modules, on the CPU in fp32.

Each case builds the flax module and its port counterpart, carries the flax
variables across with ``torch_state_dict_from_flax``, runs both on the same
numpy inputs and pulls back the same random cotangent: the JAX side through
``jax.value_and_grad`` over the parameters and the inputs, the port through
autograd, its gradients laid out as a flax tree by
``flax_tree_from_named_tensors``.  Dropout is 0 on both sides (the JAX
dropout stream cannot be reproduced).

Tolerances: forward outputs within 1e-5 of max |ref| (fp32 sum order through
a few products; measured ~1e-6), times, in training mode with BatchNorm, the
largest ratio over the normalized features of a feature's size to its batch
std (~60 for the moment head here: its whitened vech features differ little
between samples, and the norm divides their fp32 noise by that std);
every gradient, parameters and inputs, within
2e-4 relative L2 per leaf, and the GPF coefficients within 2e-3: each
``dc[p, q]`` sums large Gram terms that nearly cancel (the bar of
``tests/test_torch_training.py``).  ``norm='batch'``: the train-mode output,
gradients and updated running statistics (flax's ``mutable=['batch_stats']``,
statistics within 1e-5 of max |ref|), then the eval-mode output on the
updated statistics.

Also here: the converter's ``batch_stats`` and the new parameter names, and
that it raises on a ``batch_stats`` leaf dropped.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models import classifier_head as jch
from ego_moment_cle_vit_tpu.models import gpf as jgpf
from ego_moment_cle_vit_tpu.models import moment_head as jmh
from ego_moment_cle_vit_tpu_torch.models import classifier_head as tch
from ego_moment_cle_vit_tpu_torch.models import gpf as tgpf
from ego_moment_cle_vit_tpu_torch.models.layers import BatchNorm
from ego_moment_cle_vit_tpu_torch.models import moment_head as tmh
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)

torch.set_num_threads(1)

B, N, D = 4, 16, 32          # N < D: the token-subspace route unless told otherwise
D_CLS, D_MOMENT, CLASSES = 24, 32, 5
TOL_OUT = 1e-5
TOL_GRAD = 2e-4
TOL_GRAD_COEFFS = 2e-3


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float64)
    return out


def _rel(got, ref):
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _assert_out(got, ref, what, scale=1.0):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= TOL_OUT * scale * max(np.abs(ref).max(), 1e-30), f"{what}: {err}"


def _assert_tree(got, ref, what, ill=()):
    """Per leaf relative L2.  A leaf whose gradient is zero in exact
    arithmetic (a bias that shifts every sample alike ahead of a BatchNorm in
    training mode, or the multi-scale attention's key bias, a shift every
    softmax row shares: its reference is rounding noise, which a norm's 1/std
    magnifies as it does the forward's, to ~5e-5 of the tree's largest leaf
    norm here) must be under 1e-4 of that norm on both sides."""
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref), what
    floor = 1e-4 * max(np.linalg.norm(r) for r in ref.values())
    for path, r in ref.items():
        if np.linalg.norm(r) < floor:
            assert np.linalg.norm(got[path]) < floor, f"{what}: {path} is not ~0"
            continue
        tol = TOL_GRAD_COEFFS if path in ill else TOL_GRAD
        assert _rel(got[path], r) <= tol, f"{what}: {path} {_rel(got[path], r)}"


def _randomize(variables, seed, scale=0.5):
    """Every parameter leaf redrawn (zero-initialized ones too), so that each
    one's conversion and gradient matter."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + scale * rng.normal(size=np.shape(v))).astype(np.float32),
        variables["params"])
    return {**jax.tree_util.tree_map(np.asarray, variables), "params": params}


def _run(jmod, tmod, inputs, seed, call_kw=None, train=True, ill=()):
    """Forward + every gradient on both sides, checked; returns the flax
    variables and the port module."""
    call_kw = call_kw or {}
    dummy = [jnp.asarray(x) for x in inputs]
    variables = _randomize(jmod.init(jax.random.PRNGKey(seed), *dummy, **call_kw), seed)
    tmod.load_state_dict(torch_state_dict_from_flax(variables, tmod, device="cpu"))
    rest = {k: v for k, v in variables.items() if k != "params"}
    mutable = ["batch_stats"] if ("batch_stats" in variables and train) else False
    out_shape = jax.eval_shape(
        lambda *xs: jmod.apply(variables, *xs, **call_kw, mutable=mutable), *dummy)
    out_shape = out_shape[0] if mutable else out_shape
    cot = np.random.default_rng(seed + 1).normal(size=out_shape.shape).astype(np.float32)

    def loss(params, *xs):
        out = jmod.apply({"params": params, **rest}, *xs, **call_kw, mutable=mutable)
        out, mutated = out if mutable else (out, {})
        return jnp.sum(out * cot), (out, mutated)

    argnums = tuple(range(len(inputs) + 1))
    (_, (ref, mutated)), grads = jax.jit(jax.value_and_grad(loss, argnums, has_aux=True))(
        variables["params"], *dummy)

    tmod.train(train)
    kappa = [1.0]  # the train-mode BatchNorms' magnification, see the module docstring

    def magnification(_mod, args, _out):
        x = args[0].detach().double()
        kappa.append(float((x.abs().amax(0) / x.std(0, unbiased=False)).max()))

    hooks = [m.register_forward_hook(magnification) for m in tmod.modules()
             if isinstance(m, BatchNorm)] if train else []
    xs = [torch.from_numpy(np.array(x)).requires_grad_() for x in inputs]
    out = tmod(*xs)
    for h in hooks:
        h.remove()
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_out(out.detach().numpy(), ref, "forward", scale=max(kappa))
    named = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
    _assert_tree(flax_tree_from_named_tensors(named, tmod)["params"], grads[0], "params", ill)
    for i, (x, g) in enumerate(zip(xs, grads[1:])):
        assert _rel(x.grad.numpy().astype(np.float64), np.asarray(g, np.float64)) <= TOL_GRAD, \
            f"input {i}"
    if mutable:
        buffers = {n: b.numpy() for n, b in tmod.named_buffers()
                   if n.endswith(("running_mean", "running_var"))}
        got = flax_tree_from_named_tensors(buffers, tmod)["batch_stats"]
        for path, r in _flat(mutated["batch_stats"]).items():
            _assert_out(_flat(got)[path], r, f"batch_stats {path}")
        # eval mode reads the updated running statistics
        ref_eval = jmod.apply({**variables, "batch_stats": mutated["batch_stats"]}, *dummy,
                              **{**call_kw, "deterministic": True})
        tmod.eval()
        with torch.no_grad():
            _assert_out(tmod(*[torch.from_numpy(np.array(x)) for x in inputs]).numpy(),
                        ref_eval, "eval forward")
    return variables, tmod


def _tokens(seed, n=N, d=D, std=0.3):
    """Tokens with a scale of their own for each sample and feature: samples
    alike would give a BatchNorm a batch variance far under its features'
    size, which magnifies fp32 sum-order noise past any fixed bar."""
    rng = np.random.default_rng(seed)
    scale = std * rng.uniform(0.2, 2.0, size=(B, 1, d))
    return (rng.normal(size=(B, n, d)) * scale).astype(np.float32)


def _graph(seed, n=N):
    g = np.abs(np.random.default_rng(seed).normal(size=(B, n, n))).astype(np.float32) + 0.1
    return 0.5 * (g + g.transpose(0, 2, 1))


# ----------------------------------------------------------------------------
# adaptive GPF
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("adaptive_type", ["global", "attention", "spatial"])
def test_adaptive_gpf_matches_jax(adaptive_type, similarity):
    jmod = jgpf.AdaptiveGraphPolynomialFusion(similarity=similarity,
                                             adaptive_type=adaptive_type)
    tmod = tgpf.AdaptiveGraphPolynomialFusion(similarity=similarity, adaptive_type=adaptive_type,
                                             num_tokens=N, dim=D)
    _run(jmod, tmod, [_tokens(1), _tokens(2)], seed=3, ill=("alpha_coeffs",))
    assert sorted(n for n, _ in tmod.named_parameters()) == sorted(
        {"global": ["alpha_coeffs"], "attention": ["alpha_coeffs", "coeff_mod.bias",
                                                   "coeff_mod.weight"],
         "spatial": ["alpha_coeffs", "spatial_coeffs"]}[adaptive_type])


def test_adaptive_gpf_global_is_the_static_module():
    """'global' is the static module's function on the same coefficients."""
    a, p = torch.from_numpy(_tokens(4)), torch.from_numpy(_tokens(5))
    static = tgpf.GraphPolynomialFusion(similarity="dot")
    adaptive = tgpf.AdaptiveGraphPolynomialFusion(similarity="dot", adaptive_type="global")
    static.reset_parameters(torch.Generator().manual_seed(0))
    adaptive.load_state_dict(static.state_dict())
    assert torch.equal(static(a, p), adaptive(a, p))
    with pytest.raises(ValueError, match="adaptive_type"):
        tgpf.AdaptiveGraphPolynomialFusion(adaptive_type="temporal")


# ----------------------------------------------------------------------------
# moment heads
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("third_order", [True, False])
def test_simplified_moment_head_matches_jax(third_order):
    jmod = jmh.SimplifiedMomentHead(d_in=D, d_out=16, use_third_order=third_order, dropout=0.0)
    tmod = tmh.SimplifiedMomentHead(D, 16, third_order, dropout=0.0)
    _run(jmod, tmod, [_tokens(6), _graph(7)], seed=8, call_kw={"deterministic": False})
    assert tuple(tmod.second_proj.weight.shape) == (8 if third_order else 16, D * (D + 1) // 2)


@pytest.mark.parametrize("options", [
    {"norm": "batch"},
    {"norm": "none"},
    {"norm": "layer", "sketch_compact": True},
    {"norm": "layer", "isqrt_subspace": False},
], ids=["batch", "none", "sketch_compact", "dense_route"])
def test_moment_head_options_match_jax(options):
    kw = dict(d_out=16, use_third_order=True, sketch_dim=256, dropout=0.0)
    jmod = jmh.MomentHead(d_in=D, **kw, **options)
    tmod = tmh.MomentHead(D, **kw, **options)
    _run(jmod, tmod, [_tokens(9), _graph(10)], seed=11, call_kw={"deterministic": False})
    assert tmod.dense_route(N, D) == (not options.get("isqrt_subspace", True))


def test_sketch_compact_caps_at_two_widths():
    """At D = 64 and sketch_dim 512 the default cap (4 D = 256) and the
    compact one (2 D = 128) differ."""
    assert tmh.MomentHead(64, sketch_dim=512, use_third_order=True).sketch_matrices.shape[-1] \
        == 256
    assert tmh.MomentHead(64, sketch_dim=512, use_third_order=True,
                          sketch_compact=True).sketch_matrices.shape[-1] == 128


# ----------------------------------------------------------------------------
# classifier heads
# ----------------------------------------------------------------------------


def _head_pair(kind, norm):
    if kind == "bilinear":
        return (jch.ClassifierHead(D_CLS, D_MOMENT, CLASSES, fusion_type="bilinear", norm=norm,
                                   dropout=0.0),
                tch.ClassifierHead(D_CLS, D_MOMENT, CLASSES, fusion_type="bilinear", norm=norm,
                                   dropout=0.0))
    if kind == "multiscale":
        return (jch.MultiScaleClassifierHead(D_CLS, D_MOMENT, CLASSES, norm=norm, dropout=0.0),
                tch.MultiScaleClassifierHead(D_CLS, D_MOMENT, CLASSES, norm=norm, dropout=0.0))
    return (jch.AdaptiveClassifierHead(D_CLS, D_MOMENT, CLASSES, norm=norm, dropout=0.0),
            tch.AdaptiveClassifierHead(D_CLS, D_MOMENT, CLASSES, norm=norm, dropout=0.0))


@pytest.mark.parametrize("norm", ["layer", "batch"])
@pytest.mark.parametrize("kind", ["bilinear", "multiscale", "adaptive"])
def test_classifier_heads_match_jax(kind, norm):
    jmod, tmod = _head_pair(kind, norm)
    rng = np.random.default_rng(12)
    cls = rng.normal(size=(B, D_CLS)).astype(np.float32)
    moment = rng.normal(size=(B, D_MOMENT)).astype(np.float32)
    _run(jmod, tmod, [cls, moment], seed=13, call_kw={"deterministic": False})
    if kind == "bilinear":  # the JAX auto hidden size, max((24 + 32) // 2, 256)
        assert tuple(tmod.bilinear_kernel.shape) == (256, D_CLS, D_MOMENT)


# ----------------------------------------------------------------------------
# the converter
# ----------------------------------------------------------------------------


def test_converter_maps_batch_stats_and_the_new_names():
    """BatchNorm scale / bias / mean / var under ``BatchNorm_0``, the
    attention's DenseGeneral kernels and biases, the bilinear kernel, the
    adaptive GPF and simplified head's leaves: every flax leaf lands on its
    port entry, and the inverse gives the flax tree back bit for bit."""
    rng = np.random.default_rng(14)
    cls = jnp.asarray(rng.normal(size=(B, D_CLS)).astype(np.float32))
    moment = jnp.asarray(rng.normal(size=(B, D_MOMENT)).astype(np.float32))
    jmod, tmod = _head_pair("multiscale", "batch")
    variables = _randomize(jmod.init(jax.random.PRNGKey(0), cls, moment), 15)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 2.0, size=np.shape(v)).astype(np.float32),
        variables["batch_stats"])
    sd = torch_state_dict_from_flax(variables, tmod, device="cpu")
    assert sd["scale_norm_0.running_var"].numpy().tolist() == \
        variables["batch_stats"]["scale_norm_0"]["BatchNorm_0"]["var"].tolist()
    assert tuple(sd["scale_attention.query.weight"].shape) == (CLASSES, CLASSES)
    assert tuple(sd["scale_attention.out.bias"].shape) == (CLASSES,)
    tmod.load_state_dict(sd)
    named = {**{n: p.detach().numpy() for n, p in tmod.named_parameters()},
             **{n: b.numpy() for n, b in tmod.named_buffers()}}
    back = flax_tree_from_named_tensors(named, tmod)
    for coll in ("params", "batch_stats"):
        got, ref = _flat(back[coll]), _flat(variables[coll])
        assert sorted(got) == sorted(ref), coll
        for path, r in ref.items():
            np.testing.assert_array_equal(got[path].reshape(r.shape), r, err_msg=path)
    assert back["params"]["scale_attention"]["query"]["kernel"].shape == (CLASSES, 1, CLASSES)
    assert back["params"]["scale_attention"]["out"]["kernel"].shape == (1, CLASSES, CLASSES)


def test_converter_raises_on_a_dropped_batch_stats_leaf():
    rng = np.random.default_rng(16)
    jmod = jmh.MomentHead(d_in=D, d_out=16, use_third_order=True, sketch_dim=256, norm="batch")
    tokens, graph = jnp.asarray(_tokens(17)), jnp.asarray(_graph(18))
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(1), tokens,
                                                             graph))
    tmod = tmh.MomentHead(D, 16, True, sketch_dim=256, norm="batch")
    torch_state_dict_from_flax(variables, tmod, device="cpu")  # whole: fine
    del variables["batch_stats"]["third_norm"]["BatchNorm_0"]["mean"]
    with pytest.raises(KeyError, match="third_norm.running_mean"):
        torch_state_dict_from_flax(variables, tmod, device="cpu")
    variables["batch_stats"]["third_norm"]["BatchNorm_0"]["mean"] = rng.normal(size=8)
    variables["batch_stats"]["extra"] = {"mean": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="extra"):
        torch_state_dict_from_flax(variables, tmod, device="cpu")
