"""The port's fused attention half against the JAX package, on the CPU in fp32.

``attn_half_plain`` / ``attn_half_bwd_plain`` (the plain versions of kernels 4
and 4b) against ``fused_attn_half_spatial`` run in interpret mode, then the
port's Swin and whole model under ``attn_kernel='fused_half'`` against the
JAX ones.  The JAX side packs windows in pairs behind a -100 seal and builds
its bias and mask with its own helpers from the same table and mask; the port
attends one window at a time, so the two differ by e^-100 terms and fp32 sum
order.  Each interpret-mode reference runs once, in a module-scoped fixture.

Tolerances: forward 1e-4 absolute (outputs of size ~1-4 after the residual);
gradients 2e-4 of each leaf's largest entry (fp32 sum order through the
recomputation; measured ~1e-6); the whole model as in
``test_torch_training.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models.swin import SWIN_CONFIGS as J_SWIN_CONFIGS
from ego_moment_cle_vit_tpu.models.swin import Swin as JSwin
from ego_moment_cle_vit_tpu.models.swin import SwinConfig as JSwinConfig
from ego_moment_cle_vit_tpu.models.swin import (
    _blockdiag_mask,
    _build_bias_bd,
    _spatial_mm_pack,
    _use_fused_half,
)
from ego_moment_cle_vit_tpu.ops.pallas.attn_half import fused_attn_half_spatial
from ego_moment_cle_vit_tpu_torch.kernels import attn_half as tah
from ego_moment_cle_vit_tpu_torch.models.swin import (
    SWIN_CONFIGS,
    Swin,
    SwinBlock,
    SwinConfig,
    _attn_mask,
    _relative_position_index,
)
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)
from test_torch_training import _both_models, _config, _flat, _views

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

WS = 7
EPS = 1e-5
# (B, Hp, C, heads, shifted): stage 0 of a 112 input (pack 4, mm 2), with and
# without the shift mask, and stage 1 at C = 256 (pack 2, mm 2)
GEOMETRIES = [(1, 28, 128, 4, False), (1, 28, 128, 4, True), (1, 14, 256, 8, False)]
GRAD_GEOMETRY = GEOMETRIES[1]


def _inputs(b, hp, c, heads, shifted, seed=0):
    """Numpy inputs in the port's layouts: x, ln_g, ln_b, wqkv [3C, C], bqkv,
    wproj [C, C], bproj, table [(2ws-1)^2, H], mask [nW, T, T] or None."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.normal(size=shape)).astype(np.float32)

    mask = _attn_mask(hp, hp, hp, hp, WS, WS // 2) if shifted else None
    return dict(x=f(b, hp, hp, c), ln_g=f(c, scale=0.1, loc=1.0), ln_b=f(c, scale=0.1),
                wqkv=f(3 * c, c, scale=c ** -0.5), bqkv=f(3 * c, scale=0.1),
                wproj=f(c, c, scale=c ** -0.5), bproj=f(c, scale=0.1),
                table=f((2 * WS - 1) ** 2, heads), mask=mask)


def _jax_fn(hp, heads, has_mask):
    """(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, table, mask) in the port's
    layouts -> the Pallas kernel's output, its bias and mask built by the JAX
    package's own helpers."""
    pack = hp // WS
    mm = _spatial_mm_pack(pack)

    def fn(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, table, mask):
        t = mm * WS * WS
        madd = _blockdiag_mask(mask, mm) if has_mask else jnp.zeros((1, t, t), jnp.float32)
        return fused_attn_half_spatial(x, ln_g, ln_b, wqkv.T, bqkv, wproj.T, bproj,
                                       _build_bias_bd(table, WS, mm, heads), madd, heads, WS,
                                       pack, mm, EPS, True)

    return fn


def _jax_args(inp, c):
    mask = inp["mask"] if inp["mask"] is not None else np.zeros((1, 49, 49), np.float32)
    return [jnp.asarray(inp[k]) for k in ("x", "ln_g", "ln_b", "wqkv", "bqkv", "wproj", "bproj",
                                          "table")] + [jnp.asarray(mask)]


def _port_args(inp, heads):
    """torch tensors for attn_half: the table gathered into the [H, T, T] bias."""
    t = {k: torch.from_numpy(v) for k, v in inp.items() if v is not None}
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1))
    bias = t["table"][idx].reshape(49, 49, heads).permute(2, 0, 1).contiguous()
    return ([t[k] for k in ("x", "ln_g", "ln_b", "wqkv", "bqkv", "wproj", "bproj")]
            + [bias, t.get("mask")])


@pytest.fixture(scope="module")
def jax_forward():
    out = {}
    for geo in GEOMETRIES:
        b, hp, c, heads, shifted = geo
        inp = _inputs(*geo)
        out[geo] = (inp, np.asarray(_jax_fn(hp, heads, shifted)(*_jax_args(inp, c))))
    return out


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"{g[1]}x{g[1]}C{g[2]}s{int(g[4])}")
def test_forward_plain_matches_pallas(jax_forward, geo):
    inp, ref = jax_forward[geo]
    _, _, c, heads, _ = geo
    out = tah.attn_half_plain(*_port_args(inp, heads), heads, WS, EPS).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    # the residual is in: y - x is far from y
    assert np.abs(out - inp["x"]).max() < 0.9 * np.abs(out).max()
    # and the wrapper takes the plain version on the CPU, launching nothing
    before = tah.attn_half_fwd.launches
    again = tah.attn_half_fwd(*_port_args(inp, heads), heads, WS, EPS)
    assert torch.equal(again, torch.from_numpy(out)) and tah.attn_half_fwd.launches == before


@pytest.fixture(scope="module")
def jax_backward():
    b, hp, c, heads, shifted = GRAD_GEOMETRY
    inp = _inputs(*GRAD_GEOMETRY, seed=1)
    dy = np.random.default_rng(2).normal(size=inp["x"].shape).astype(np.float32)
    args = _jax_args(inp, c)
    fn = _jax_fn(hp, heads, shifted)
    _, vjp = jax.vjp(lambda *a: fn(*a, args[-1]), *args[:-1])
    return inp, dy, [np.asarray(g) for g in vjp(jnp.asarray(dy))]


NAMES = ["x", "ln_g", "ln_b", "wqkv", "bqkv", "wproj", "bproj", "table"]


def _assert_grads_close(got, ref):
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-4 * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("route", ["function", "autograd_of_plain"])
def test_backward_matches_pallas_vjp(jax_backward, route):
    inp, dy, ref = jax_backward
    heads = GRAD_GEOMETRY[3]
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in inp.items()
         if v is not None and k != "mask"}
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1))
    bias = t["table"][idx].reshape(49, 49, heads).permute(2, 0, 1).contiguous()
    args = [t[k] for k in NAMES[:-1]] + [bias, torch.from_numpy(inp["mask"])]
    fn = tah.attn_half if route == "function" else tah.attn_half_plain
    y = fn(*args, heads, WS, EPS)
    y.backward(torch.from_numpy(dy))
    _assert_grads_close([t[k].grad.numpy() for k in NAMES], ref)


def test_bwd_plain_returns_every_gradient(jax_backward):
    """attn_half_bwd_plain called directly: dx and the seven parameter
    gradients, dbias pulled back to the table through the index gather."""
    inp, dy, ref = jax_backward
    heads = GRAD_GEOMETRY[3]
    args = _port_args(inp, heads)
    grads = tah.attn_half_bwd_plain(*args, torch.from_numpy(dy), heads, WS, EPS)
    assert len(grads) == 8 and grads[0].dtype == torch.float32
    dbias = grads[-1]
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1))
    dtable = torch.zeros(inp["table"].shape).index_add_(
        0, idx, dbias.permute(1, 2, 0).reshape(-1, heads))
    _assert_grads_close([g.numpy() for g in grads[:-1]] + [dtable.numpy()], ref)


# ---------------------------------------------------------------------------
# the Swin and the whole model under attn_kernel='fused_half'
# ---------------------------------------------------------------------------

KW = dict(img_size=56, embed_dim=128, depths=(2, 2), num_heads=(4, 8))
KW_PADDED = dict(KW, img_size=64)  # 16 x 16 tokens pad to 21 x 21


def _swin_params(kw, seed):
    x = np.random.default_rng(seed).normal(size=(2, kw["img_size"], kw["img_size"], 3))
    x = x.astype(np.float32)
    params = JSwin(JSwinConfig(**kw)).init(jax.random.PRNGKey(1), jnp.asarray(x))
    # LayerNorm scales/biases and bias tables away from their init
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(2)
    leaves = [np.asarray(l) + 0.05 * rng.normal(size=l.shape).astype(np.float32) for l in leaves]
    return x, jax.tree_util.tree_unflatten(tree, leaves)


def _port_swin(kw, params, attn_kernel="fused_half"):
    model = Swin(SwinConfig(attn_kernel=attn_kernel, **kw), dtype=torch.float32,
                 device="cpu").eval()
    model.load_state_dict(torch_state_dict_from_flax(params, model, device="cpu"))
    return model


@pytest.fixture(scope="module")
def swin_case():
    x, params = _swin_params(KW, 0)
    jm = JSwin(JSwinConfig(attn_kernel="fused_half", **KW))
    y, vjp = jax.vjp(lambda p: jm.apply(p, jnp.asarray(x)), params)
    cot = np.random.default_rng(3).normal(size=y.shape).astype(np.float32)
    (grads,) = vjp(jnp.asarray(cot))
    return x, params, np.asarray(y), cot, grads


def test_swin_fuses_the_blocks_jax_fuses(swin_case):
    _, params, _, _, _ = swin_case
    model = _port_swin(KW, params)
    blocks = [getattr(model, n) for n in model.layer_names if n.endswith(("block0", "block1"))]
    assert [b.fused for b in blocks] == [True] * 4
    assert model.stage0_block1.shift == 3 and model.stage0_block1.attn_mask is not None


def test_swin_forward_and_gradients_match_jax(swin_case):
    x, params, ref, cot, ref_grads = swin_case
    model = _port_swin(KW, params)
    out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-4)
    out.backward(torch.from_numpy(cot))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    got = _flat(flax_tree_from_named_tensors(grads, model)["params"])
    want = _flat(jax.tree_util.tree_map(np.asarray, ref_grads)["params"])
    assert sorted(got) == sorted(want) and len(want) > 30
    for path, r in want.items():
        np.testing.assert_allclose(got[path], r, rtol=0, atol=2e-4 * np.abs(r).max(),
                                   err_msg=path)


def test_swin_padded_geometry_forward_matches_jax():
    x, params = _swin_params(KW_PADDED, 4)
    ref = JSwin(JSwinConfig(attn_kernel="fused_half", **KW_PADDED)).apply(params, jnp.asarray(x))
    model = _port_swin(KW_PADDED, params)
    assert model.stage0_block0.fused and model.stage0_block0.hp == 21
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-4)
    # the default path on the same weights agrees as well (pad before LN
    # changes only e^-100 terms)
    with torch.no_grad():
        plain = _port_swin(KW_PADDED, params, "auto")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, plain, rtol=0, atol=1e-4)


def _fused_config(**moment):
    cfg = _config(**moment)
    cfg["model"]["backbone_attn_kernel"] = "fused_half"
    return cfg


def test_model_loss_and_every_gradient_match_jax():
    cfg = _fused_config()
    jm, variables, model = _both_models(cfg)
    assert all(model.backbone.backbone.swin.get_submodule(n).fused
               for n in ("stage0_block0", "stage1_block0"))
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
    for key, value in out["loss_dict"].items():
        assert value.item() == pytest.approx(float(ref_dict[key]), rel=1e-5, abs=1e-7), key
    out["loss"].backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    got = _flat(flax_tree_from_named_tensors(grads, model)["params"])
    ref = _flat(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert sorted(got) == sorted(ref)
    for path, r in ref.items():
        tol = 2e-3 if path == "gpf/alpha_coeffs" else 2e-4
        assert np.abs(got[path] - r).max() <= tol * np.abs(r).max(), path


def test_three_train_steps_match_jax(monkeypatch):
    from test_torch_training import test_three_train_steps_match_jax as three_steps
    import test_torch_training

    monkeypatch.setattr(test_torch_training, "_config",
                        lambda **moment: _fused_config(**moment))
    three_steps(monkeypatch)


# ---------------------------------------------------------------------------
# block choice and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, img_size", [
    ("swin_micro_patch4_window7_56", 56), ("swin_micro_patch4_window7_56", 64),
    ("swin_tiny_patch4_window7_224", 224), ("swin_base_patch4_window7_224", 224),
    ("swin_large_patch4_window7_224", 224)])
def test_block_choice_matches_jax(name, img_size):
    cfg = dataclasses.replace(SWIN_CONFIGS[name], img_size=img_size, attn_kernel="fused_half")
    model = Swin(cfg, device="meta")
    chosen = {}
    for layer in model.layer_names:
        blk = getattr(model, layer)
        if isinstance(blk, SwinBlock):
            c = blk.attn.qkv.weight.shape[1]
            pack = blk.wp // blk.ws
            ref = _use_fused_half("fused_half", blk.hp, blk.wp, blk.ws, c, blk.num_heads, pack,
                                  _spatial_mm_pack(pack)) is not None
            assert blk.fused == ref, layer
            chosen[layer] = blk.fused
    fused_stages = {int(k[5]) for k, v in chosen.items() if v}
    expected = {"swin_micro_patch4_window7_56": {0, 1}, "swin_tiny_patch4_window7_224": set(),
                "swin_base_patch4_window7_224": {0, 1},
                "swin_large_patch4_window7_224": set()}[name]
    assert fused_stages == expected
    assert J_SWIN_CONFIGS[name].depths == cfg.depths


def test_fused_half_flax_tree_loads_with_no_missing_or_unused_key():
    x = jnp.zeros((1, 56, 56, 3), jnp.float32)
    shapes = jax.eval_shape(JSwin(JSwinConfig(attn_kernel="fused_half", **KW)).init,
                            jax.random.PRNGKey(5), x)
    params = jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), shapes)
    model = Swin(SwinConfig(attn_kernel="fused_half", **KW), device="cpu")
    sd = torch_state_dict_from_flax(params, model, device="cpu")  # raises on either
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd, strict=True)


def test_unknown_attn_kernel_raises():
    with pytest.raises(ValueError, match="attn_kernel"):
        Swin(SwinConfig(attn_kernel="fused", **KW), device="cpu")


@pytest.mark.parametrize("b, hp, c, heads", [(128, 56, 128, 4), (128, 28, 256, 8),
                                             (64, 56, 128, 4), (3, 21, 128, 4), (1, 7, 256, 8)])
def test_backward_geometry_leaves_no_chunk_empty(b, hp, c, heads):
    """The backward's chunking, as the CUDA entry point checks it: every image
    chunk and every token chunk holds work, so no partial is left unwritten."""
    m, n_win = b * hp * hp, (hp // WS) ** 2
    geo = tah.bwd_geometry(b, m, c, n_win, heads)
    for total, n in ((b, geo["attn_chunks"]), (-(-m // 64), geo["w_chunks"])):
        per = -(-total // n)
        assert 1 <= n <= total and (n - 1) * per < total
    assert 1 <= geo["dx_blocks"] <= -(-m // 64)
    x = torch.empty(b, hp, hp, c, dtype=torch.bfloat16, device="meta")
    sizes = tah.scratch_bytes(x, heads, WS)
    assert sizes["xn, om, dqkv (compute type)"] == m * 5 * c * 2
    assert sizes["dbias partials"] == geo["attn_chunks"] * n_win * heads * 49 * 49 * 4


@pytest.mark.parametrize("b, hp, c, heads", [(3, 21, 128, 4), (2, 14, 256, 8), (5, 35, 128, 4)])
def test_chunked_weight_gradient_sums_equal_the_whole_product(b, hp, c, heads):
    """Kernel 4b's weight and bias gradients as its bf16 path sums them: one
    fp32 partial per chunk of 64-token tiles (the geometry's chunks), the
    partials added in chunk order, against the product over all tokens at
    once: within 1e-5 of the largest entry."""
    m = b * hp * hp
    geo = tah.bwd_geometry(b, m, c, (hp // WS) ** 2, heads)
    rng = np.random.default_rng(7)
    # operands as the kernel reads them: bf16 values, fp32 sums
    dqkv = torch.from_numpy(rng.normal(size=(m, 3 * c))).to(torch.bfloat16).float()
    xn = torch.from_numpy(rng.normal(size=(m, c))).to(torch.bfloat16).float()
    per = -(-(-(-m // 64)) // geo["w_chunks"]) * 64
    dw = torch.zeros(3 * c, c)
    db = torch.zeros(3 * c)
    for chunk in range(geo["w_chunks"]):
        rows = slice(chunk * per, min(m, (chunk + 1) * per))
        dw = dw + dqkv[rows].T @ xn[rows]
        db = db + dqkv[rows].sum(dim=0)
    whole_w, whole_b = dqkv.T @ xn, dqkv.sum(dim=0)
    assert ((dw - whole_w).abs().max() / whole_w.abs().max()).item() <= 1e-5
    assert ((db - whole_b).abs().max() / whole_b.abs().max()).item() <= 1e-5
