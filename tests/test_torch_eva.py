"""The port's EVA-02 backbone (``models/eva.py``) and the whole model on it,
against the benchmark's plain reference (``h100_bench/reference/families/
eva.py``), on the CPU.  The JAX package has no EVA, so the reference is the
equations written again in plain float32 ``torch``.

``eva02_micro_patch14_56`` (D 128, 2 blocks, 2 heads of 64, SwiGLU 341) under
the flagship's heads, in float32, at two inputs: 56 px (17 tokens, the packed
attention's path; N = 16 < D, the token-subspace iSQRT) and 224 px (257
tokens, past the packed kernel, so kernel 6's path; N = 256 >= D, the dense
Newton–Schulz route, as EVA-02-L at 448 takes them on the card).  Weights
are the benchmark's (``h100_bench.weights`` from a seed, by the reference's
plan), loaded into both by name with ``strict=True``.

* The rotary tables against a float64 closed form written entry by entry.
* Backbone tokens and served logits (``make_infer_fn``) against the
  reference.  Both sides compute the same float32 operations in the same
  order, so they agree to a few float32 roundings (measured: tokens equal,
  logits ~4e-7 relative, the iSQRT's iterations amplifying the heads'
  rounding); the tolerances, 1e-5 and 1e-4 relative, leave room for another
  BLAS blocking and are the ones ``h100_bench/tests/test_h100b_reference.py``
  holds the other families to.
* One ``make_train_step`` (augmentation, dropout, the five-term loss) with
  and without ``remat='block'``: the loss within 1e-5 relative and every
  leaf's gradient within 1e-3 of its norm (leaves with a gradient above a
  thousandth of the median leaf's), as the benchmark's reference test holds
  the ViT; measured ~1e-6.
* State-dict names both ways, the rotary tables in none.
* Four faults of the backbone (RoPE left out, RoPE on halves instead of
  interleaved pairs, the row and column angles swapped, the SwiGLU's hidden
  LayerNorm left out), each of which must move the served logits a hundred
  times past the logits' tolerance.  ``FAULTS`` is also what a card run
  plants.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_infer_fn
from ego_moment_cle_vit_tpu_torch import make_train_step
from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug
from ego_moment_cle_vit_tpu_torch.models import eva
from ego_moment_cle_vit_tpu_torch.models.backbone import (
    backbone_family,
    backbone_num_features,
    backbone_num_patches,
)
from h100_bench import harness
from h100_bench.kinds.train import mix
from h100_bench.reference import augment as ref_aug
from h100_bench.reference.families import eva as ref_eva
from h100_bench.reference.model import RefModel
from h100_bench.weights import make_batches

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 21
B = 2
TOL_TOKENS, TOL_LOGITS, TOL_GRAD, TOL_LOSS = 1e-5, 1e-4, 1e-3, 1e-5


def micro_spec(img: int) -> dict:
    """The benchmark's EVA-02-L configuration with the micro backbone at
    ``img`` px, its heads cut to d_out 256 and sketch 512, in float32."""
    spec = json.loads((REPO / "h100_bench" / "configs" / "eva02L14-448-flagship.json").read_text())
    cfg = eva.EVA_CONFIGS["eva02_micro_patch14_56"]
    spec["architecture"].update(
        backbone_name="eva02_micro_patch14_56", img_size=img, embed_dim=cfg.embed_dim,
        depth=cfg.depth, num_heads=cfg.num_heads, mlp_hidden=cfg.mlp_hidden,
        rope_ref_grid=cfg.rope_ref_grid, num_features=cfg.embed_dim)
    spec["input"] = {"input_size": img, "resize_size": img + 8}
    model = spec["port_config"]["model"]
    model.update(backbone_name="eva02_micro_patch14_56", bf16=False)
    model["moment"].update(d_out=256, sketch_dim=512, bf16_params=False)
    spec["port_config"]["data"] = dict(spec["input"])
    spec["reference_chunk"] = 1
    return spec


SPECS = {"56": micro_spec(56), "224": micro_spec(224)}


def pair(spec: dict, remat: str = "none"):
    """The program and the reference on the benchmark's weights for SEED."""
    spec = copy.deepcopy(spec)
    spec["port_config"]["model"]["backbone_remat"] = remat
    cell = harness.Cell("eva-micro", None, spec, {"batch": B}, 1, {}, [], [])
    weights = harness.make_weights(cell, SEED, torch.device("cpu"))
    prog = create_model(spec["port_config"], spec["num_classes"], device="cpu")
    prog.load_state_dict(weights, strict=True)
    ref = RefModel(spec)
    ref.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True)
    return prog, ref, weights


def images_and_labels(spec: dict):
    images, labels = make_batches(SEED, 1, B, spec["input"]["resize_size"], spec["num_classes"],
                                  "cpu")
    return images[0], labels[0]


def rel(a, b):
    return float((a - b).norm() / b.norm())


def served(spec: dict):
    """(program logits through ``make_infer_fn``, reference logits)."""
    prog, ref, _ = pair(spec)
    images, _ = images_and_labels(spec)
    infer = make_infer_fn(prog, prog_aug.AugmentConfig(**spec["input"]), device="cpu")
    anchor, _ = ref_aug.dual_view_eval_batch(images, ref_aug.AugmentConfig(**spec["input"]))
    return infer(images), ref.infer(anchor)


# ----------------------------------------------------------------------------
# the rotary tables
# ----------------------------------------------------------------------------


def closed_form(grid: int, ref_grid: int, head_dim: int):
    """cos and sin [grid^2, head_dim] in float64, entry by entry: channel i
    of patch (r, c) has band j = (i // 2) mod d/4 of the row (i < d/2) or
    column angle, at the position scaled by ref_grid / grid."""
    bands = head_dim // 4
    cos = torch.empty(grid * grid, head_dim, dtype=torch.float64)
    sin = torch.empty_like(cos)
    for r in range(grid):
        for c in range(grid):
            for i in range(head_dim):
                pair_index = i // 2
                pos = (r if pair_index < bands else c) * ref_grid / grid
                angle = torch.tensor(pos * 10000.0 ** (-(pair_index % bands) / bands),
                                     dtype=torch.float64)
                cos[r * grid + c, i], sin[r * grid + c, i] = angle.cos(), angle.sin()
    return cos, sin


@pytest.mark.parametrize("grid,ref_grid", [(32, 16), (4, 4), (16, 4)])
def test_rope_tables_are_the_closed_form(grid, ref_grid):
    want = closed_form(grid, ref_grid, 64)
    # the port's tables before they are stored, float64 against float64
    for got, w in zip(eva.rope_tables(grid, ref_grid, 64), want):
        assert float((got - w).abs().max()) < 1e-12
    # the reference's, float32: one rounding of entries in [-1, 1]
    for got, w in zip(ref_eva.rope_tables(grid, ref_grid, 64, "cpu"), want):
        assert got.dtype == torch.float32 and float((got.double() - w).abs().max()) < 6e-8


def test_stored_table_leads_with_the_cls_row():
    """The model's table (complex64 ``cos + i sin`` of each pair's angle, the
    CLS row first and 1, so the CLS token passes the rotation unchanged) at
    EVA-02-L's grid."""
    cfg = eva.EVA_CONFIGS["eva02_large_patch14_448"]
    assert (cfg.grid, cfg.rope_ref_grid, cfg.embed_dim // cfg.num_heads) == (32, 16, 64)
    net = eva.EVA(eva.EVAConfig(img_size=448, depth=1, embed_dim=128, num_heads=2,
                                mlp_hidden=341))
    cos, sin = closed_form(32, 16, 64)
    assert net.rope.dtype == torch.complex64 and net.rope.shape == (1025, 32)
    assert torch.equal(net.rope[0], torch.ones(32, dtype=torch.complex64))
    assert float((net.rope[1:].real.double() - cos[:, 0::2]).abs().max()) < 6e-8
    assert float((net.rope[1:].imag.double() - sin[:, 0::2]).abs().max()) < 6e-8
    assert not any("rope" in n for n in net.state_dict())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-7), (torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -8)])
def test_rotation_is_the_equations(dtype, tol):
    """``apply_rope`` on the model's table against ``x cos + rot(x) sin`` in
    float64 with the reference's ``rot``, at EVA-02-L's grid and head width,
    each entry's error over its pair's norm (which the rotation keeps):
    float64 to the table's one float32 rounding (6e-8), float32 to a few of
    its roundings, bfloat16 to one rounding of the output."""
    net = eva.EVA(eva.EVAConfig(img_size=448, depth=1, embed_dim=128, num_heads=2,
                                mlp_hidden=341))
    x = torch.randn(2, 1025, 128, generator=torch.Generator().manual_seed(1)).to(dtype)
    cos, sin = closed_form(32, 16, 64)
    cos = torch.cat([torch.ones(1, 64, dtype=torch.float64), cos])
    sin = torch.cat([torch.zeros(1, 64, dtype=torch.float64), sin])
    heads = x.double().unflatten(-1, (2, 64))
    want = (heads * cos[:, None] + ref_eva.rot(heads) * sin[:, None]).flatten(-2)
    got = eva.apply_rope(x, net.rope, 2)
    assert got.dtype == dtype
    assert torch.equal(got[:, 0], x[:, 0])  # the CLS token is not rotated
    pair_norm = x.double().unflatten(-1, (-1, 2)).norm(dim=-1).repeat_interleave(2, dim=-1)
    assert float(((got.double() - want).abs() / pair_norm).max()) < tol


# ----------------------------------------------------------------------------
# the registry and the state dict
# ----------------------------------------------------------------------------


def test_registry():
    assert backbone_family("eva02_large_patch14_448") == "eva"
    assert backbone_num_features("eva02_large_patch14_448") == 1024
    assert backbone_num_patches("eva02_large_patch14_448") == 1024
    assert backbone_num_patches("eva02_micro_patch14_56", 224) == 256
    cfg = eva.EVA_CONFIGS["eva02_large_patch14_448"]
    assert (cfg.depth, cfg.num_heads, cfg.mlp_hidden) == (24, 16, int(1024 * 8 / 3))
    with pytest.raises(ValueError, match="Unknown backbone"):
        backbone_family("eva02_huge")


def test_state_dict_names_both_ways():
    prog, ref, _ = pair(SPECS["56"])
    names = set(prog.state_dict())
    assert names == set(ref.state_dict())
    block = {n[len("backbone.backbone.eva.blocks_0."):] for n in names
             if n.startswith("backbone.backbone.eva.blocks_0.")}
    assert block == {
        "norm1.weight", "norm1.bias", "attn.q_proj.weight", "attn.q_proj.bias",
        "attn.k_proj.weight", "attn.v_proj.weight", "attn.v_proj.bias", "attn.proj.weight",
        "attn.proj.bias", "norm2.weight", "norm2.bias", "mlp.fc1_g.weight", "mlp.fc1_g.bias",
        "mlp.fc1_x.weight", "mlp.fc1_x.bias", "mlp.norm.weight", "mlp.norm.bias",
        "mlp.fc2.weight", "mlp.fc2.bias"}
    assert {"backbone.backbone.eva.cls_token", "backbone.backbone.eva.pos_embed",
            "backbone.backbone.eva.patch_embed.proj.weight",
            "backbone.backbone.eva.norm.weight"} <= names
    assert not any("rope" in n for n in names)
    # each side takes the other's state dict whole
    prog.load_state_dict(ref.state_dict(), strict=True)
    ref.load_state_dict(prog.state_dict(), strict=True)


# ----------------------------------------------------------------------------
# forward and gradients against the reference
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("size", sorted(SPECS))
def test_tokens_and_logits(size):
    spec = SPECS[size]
    prog, ref, _ = pair(spec)
    images, _ = images_and_labels(spec)
    anchor, _ = ref_aug.dual_view_eval_batch(images, ref_aug.AugmentConfig(**spec["input"]))
    with torch.no_grad():
        feats = prog.backbone.forward_single(anchor)
        patch, glob = ref.backbone.backbone.features(ref.tokens(anchor))
    assert rel(feats["patch_tokens"], patch) < TOL_TOKENS
    assert rel(feats["global_features"], glob) < TOL_TOKENS
    infer = make_infer_fn(prog, prog_aug.AugmentConfig(**spec["input"]), device="cpu")
    assert rel(infer(images), ref.infer(anchor)) < TOL_LOGITS


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("size", sorted(SPECS))
def test_gradients_under_one_train_step(size, remat):
    spec = SPECS[size]
    prog, ref, _ = pair(spec, remat)
    assert prog.backbone.backbone.eva.config.remat == remat
    images, labels = images_and_labels(spec)
    state = create_train_state(prog, spec["port_config"], spec["steps_per_epoch"], device="cpu")
    step = make_train_step(prog, prog_aug.AugmentConfig(**spec["input"]), device="cpu")
    # the gradients as the update receives them (it clips them in place)
    grads, update = {}, state.optimizer.step

    def snapshot(*args, **kwargs):
        grads.update((n, p.grad.clone()) for n, p in prog.named_parameters())
        return update(*args, **kwargs)
    state.optimizer.step = snapshot
    gen = torch.Generator().manual_seed(SEED % 1000)
    loss = float(step(state, images, labels, gen))

    aug_gen, drop_gen = (torch.Generator().manual_seed(mix(gen.initial_seed(), 0, purpose))
                         for purpose in (0, 1))
    anchor, positive = ref_aug.dual_view_train_batch(images, aug_gen,
                                                     ref_aug.AugmentConfig(**spec["input"]))
    ref_loss = float(ref.loss_and_grads(anchor, positive, labels, drop_gen))
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)

    ref_params = dict(ref.named_parameters())
    norms = {n: float(p.grad.norm()) for n, p in ref_params.items()}
    floor = 1e-3 * sorted(norms.values())[len(norms) // 2]
    checked = 0
    for name, _ in prog.named_parameters():
        if norms[name] >= floor:  # leaves with a gradient to speak of
            assert rel(grads[name], ref_params[name].grad) < TOL_GRAD, name
            checked += 1
    eva_leaves = [n for n in norms if ".eva." in n and norms[n] >= floor]
    assert checked > len(eva_leaves) > 30


# ----------------------------------------------------------------------------
# faults of the backbone move the logits
# ----------------------------------------------------------------------------


ROPE_TABLES = eva.rope_tables  # the faults below derive theirs from it


def _rope_on_halves(monkeypatch):
    """Each head's halves paired, (x_i, x_i+d/2) turned by pair i's angle, in
    place of the interleaved pairs (x_2i, x_2i+1)."""
    def halves(x, rope, num_heads):
        pairs = x.unflatten(-1, (num_heads, 2, -1)).transpose(-1, -2)
        turned = torch.view_as_complex(pairs.float().contiguous()) * rope[:, None]
        return torch.view_as_real(turned).transpose(-1, -2).flatten(-3).to(x.dtype)
    monkeypatch.setattr(eva, "apply_rope", halves)


def _rows_and_columns_swapped(monkeypatch):
    def tables(grid, ref_grid, head_dim):
        cos, sin = ROPE_TABLES(grid, ref_grid, head_dim)
        swap = torch.arange(grid * grid).reshape(grid, grid).t().reshape(-1)
        return cos[swap], sin[swap]
    monkeypatch.setattr(eva, "rope_tables", tables)


def _rope_left_out(monkeypatch):
    monkeypatch.setattr(eva, "apply_rope", lambda x, rope, num_heads: x)


def _hidden_norm_left_out(monkeypatch):
    monkeypatch.setattr(eva.SwiGLU, "forward",
                        lambda self, x: self.fc2(torch.nn.functional.silu(self.fc1_g(x))
                                                 * self.fc1_x(x)))


@pytest.mark.parametrize("width", [341, 2730])
def test_padded_hidden_width_is_exact(width):
    """The SwiGLU's products at the width the card pads them to (341 -> 344,
    EVA-02-L's 2730 -> 2736) give the plain products' result, value and
    gradient, in fp64 to its rounding."""
    mlp = eva.SwiGLU(64, width, 1e-6, torch.float64, "cpu").double()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64) * 0.3)
    x = torch.randn(2, 5, 64, generator=g, dtype=torch.float64)
    pad = -width % eva.ALIGN
    assert pad > 0 and (width + pad) % 8 == 0
    outs = []
    for p in (0, pad):
        mlp.zero_grad()
        out = mlp.padded(x, p)
        out.pow(2).sum().backward()
        outs.append((out.detach(), [q.grad.clone() for q in mlp.parameters()]))
    (plain, g_plain), (padded, g_padded) = outs
    assert float((padded - plain).abs().max()) < 1e-12 * float(plain.abs().max())
    for a, b in zip(g_padded, g_plain):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) < 1e-12 * float(b.abs().max())


FAULTS = {"rope_left_out": _rope_left_out, "rope_on_halves": _rope_on_halves,
          "rows_and_columns_swapped": _rows_and_columns_swapped,
          "hidden_norm_left_out": _hidden_norm_left_out}


def plant(fault: str, monkeypatch) -> None:
    """Plant a fault in the port's EVA (before the model is built: the
    rotary tables are formed at build)."""
    FAULTS[fault](monkeypatch)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_moves_the_logits(monkeypatch, fault):
    spec = SPECS["224"]
    out, ref = served(spec)
    assert rel(out, ref) < TOL_LOGITS
    plant(fault, monkeypatch)
    out, ref = served(spec)
    assert rel(out, ref) > 100 * TOL_LOGITS, fault
