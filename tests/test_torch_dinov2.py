"""The port's DINOv2 with registers (``models/vit.py``'s ViT with its DINOv2
options, ``DINOV2_CONFIGS``) and the whole model on it, against the
benchmark's plain reference (``h100_bench/reference/families/dinov2.py``),
on the CPU.  The JAX package's ViT has none of these options, so the
reference is the equations written again in plain float32 ``torch``; the
plain ViT keeps its JAX parity tests (``test_torch_vit.py``).

``vit_micro_patch14_reg4_dinov2`` (D 128, 2 blocks, 2 heads of 64, packed
SwiGLU 341, 4 registers) under the flagship's heads, in float32, at 56 px:
CLS, 4 registers and 16 patches, 21 tokens (the packed attention's path);
N = 16 < D, the token-subspace iSQRT, as ViT-g/14 at 518 takes it on the
card (N = 1369 < D = 1536).  Weights are the benchmark's
(``h100_bench.weights`` from a seed, by the reference's plan: the LayerScale
vectors about N(0, 1), so each branch counts), loaded into both by name with
``strict=True``.

* The registry, and every ``VIT_CONFIGS`` entry's leaves against the names
  and shapes it had before the options (none of them turns one on).
* State-dict names both ways; the tokens handed to the heads (CLS and the
  registers stripped, 16 patches, CLS the global feature).
* Backbone tokens and served logits (``make_infer_fn``) against the
  reference.  Both sides compute the same float32 operations in the same
  order, so they agree to a few float32 roundings; the tolerances, 1e-5 and
  1e-4 relative, leave room for another BLAS blocking and are the ones
  ``test_torch_eva.py`` and the benchmark's reference test hold the other
  families to (the logits' larger one: the iSQRT's iterations amplify the
  heads' rounding).
* One ``make_train_step`` (augmentation, dropout, the five-term loss) with
  and without ``remat='block'``: the loss within 1e-5 relative and every
  leaf's gradient within 1e-3 of its norm (leaves with a gradient above a
  thousandth of the median leaf's), as ``test_torch_eva.py`` holds EVA.
* Four faults of the backbone (LayerScale left out, SiLU on the second half,
  the registers left out of the sequence, the position embedding shifted
  onto the prefix), each of which must move the served logits a hundred
  times past the logits' tolerance.  ``FAULTS`` is also what a card run
  plants.
"""

import copy
import dataclasses
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_infer_fn
from ego_moment_cle_vit_tpu_torch import make_train_step
from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug
from ego_moment_cle_vit_tpu_torch.models import vit
from ego_moment_cle_vit_tpu_torch.models.backbone import (
    backbone_family,
    backbone_num_features,
    backbone_num_patches,
)
from ego_moment_cle_vit_tpu_torch.utils.trace import PREFIX
from h100_bench import harness
from h100_bench.kinds.train import mix
from h100_bench.reference import augment as ref_aug
from h100_bench.reference.model import RefModel
from h100_bench.weights import make_batches

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 25
B = 2
MICRO = "vit_micro_patch14_reg4_dinov2"
TOL_TOKENS, TOL_LOGITS, TOL_GRAD, TOL_LOSS = 1e-5, 1e-4, 1e-3, 1e-5


def micro_spec() -> dict:
    """The benchmark's DINOv2-g configuration with the micro backbone, its
    heads cut to d_out 256 and sketch 512, in float32."""
    spec = json.loads(
        (REPO / "h100_bench" / "configs" / "dinov2g14-reg4-518-flagship.json").read_text())
    cfg = vit.DINOV2_CONFIGS[MICRO]
    spec["architecture"].update(
        backbone_name=MICRO, img_size=cfg.img_size, embed_dim=cfg.embed_dim, depth=cfg.depth,
        num_heads=cfg.num_heads, mlp_hidden=cfg.swiglu_hidden,
        num_registers=cfg.num_registers, num_features=cfg.embed_dim)
    spec["input"] = {"input_size": cfg.img_size, "resize_size": cfg.img_size + 8}
    model = spec["port_config"]["model"]
    model.update(backbone_name=MICRO, bf16=False)
    model["moment"].update(d_out=256, sketch_dim=512, bf16_params=False)
    spec["port_config"]["data"] = dict(spec["input"])
    spec["reference_chunk"] = 1
    return spec


SPEC = micro_spec()


def pair(remat: str = "none"):
    """The program and the reference on the benchmark's weights for SEED."""
    spec = copy.deepcopy(SPEC)
    spec["port_config"]["model"]["backbone_remat"] = remat
    cell = harness.Cell("dinov2-micro", None, spec, {"batch": B}, 1, {}, [], [])
    weights = harness.make_weights(cell, SEED, torch.device("cpu"))
    prog = create_model(spec["port_config"], spec["num_classes"], device="cpu")
    prog.load_state_dict(weights, strict=True)
    ref = RefModel(spec)
    ref.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True)
    return prog, ref, weights


def images_and_labels():
    images, labels = make_batches(SEED, 1, B, SPEC["input"]["resize_size"], SPEC["num_classes"],
                                  "cpu")
    return images[0], labels[0]


def eval_views(images):
    return ref_aug.dual_view_eval_batch(images, ref_aug.AugmentConfig(**SPEC["input"]))[0]


def rel(a, b):
    return float((a - b).norm() / b.norm())


def served():
    """(program logits through ``make_infer_fn``, reference logits)."""
    prog, ref, _ = pair()
    images, _ = images_and_labels()
    infer = make_infer_fn(prog, prog_aug.AugmentConfig(**SPEC["input"]), device="cpu")
    return infer(images), ref.infer(eval_views(images))


# ----------------------------------------------------------------------------
# the registry and the leaves
# ----------------------------------------------------------------------------


def test_registry():
    name = "vit_giant_patch14_reg4_dinov2"
    assert backbone_family(name) == backbone_family(MICRO) == "vit"
    assert backbone_num_features(name) == 1536
    assert backbone_num_patches(name) == 1369  # 37 x 37: CLS and the registers are not patches
    assert backbone_num_patches(MICRO) == 16
    cfg = vit.DINOV2_CONFIGS[name]
    assert (cfg.img_size, cfg.patch_size, cfg.embed_dim, cfg.depth, cfg.num_heads) == (
        518, 14, 1536, 40, 24)
    assert (cfg.swiglu_hidden, cfg.num_registers, cfg.no_embed_class, cfg.layer_scale) == (
        4096, 4, True, 1e-5)
    assert cfg.layer_norm_eps == 1e-6
    # apart from the registry that mirrors the JAX package's
    assert not set(vit.DINOV2_CONFIGS) & set(vit.VIT_CONFIGS)


def plain_vit_leaves(cfg) -> dict:
    """{name: shape} of a ViT without DINOv2's options, written out."""
    d, p, n = cfg.embed_dim, cfg.patch_size, cfg.num_patches
    hidden = int(d * cfg.mlp_ratio)
    out = {"cls_token": (1, 1, d), "pos_embed": (1, 1 + n, d),
           "patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,),
           "norm.weight": (d,), "norm.bias": (d,)}
    for i in range(cfg.depth):
        block = {"norm1.weight": (d,), "norm1.bias": (d,), "attn.qkv.weight": (3 * d, d),
                 "attn.qkv.bias": (3 * d,), "attn.proj.weight": (d, d), "attn.proj.bias": (d,),
                 "norm2.weight": (d,), "norm2.bias": (d,), "mlp.fc1.weight": (hidden, d),
                 "mlp.fc1.bias": (hidden,), "mlp.fc2.weight": (d, hidden), "mlp.fc2.bias": (d,)}
        out.update({f"blocks_{i}.{k}": v for k, v in block.items()})
    return out


@pytest.mark.parametrize("name", sorted(vit.VIT_CONFIGS))
def test_every_registered_vit_keeps_its_leaves(name):
    """The options are off in every ``VIT_CONFIGS`` entry: its leaves are the
    plain ViT's, names and shapes (two blocks at full width, on the meta
    device), its blocks neither scaled nor gated, and its tokens led by CLS
    alone."""
    cfg = dataclasses.replace(vit.VIT_CONFIGS[name], depth=2)
    assert (cfg.num_registers, cfg.no_embed_class, cfg.layer_scale, cfg.swiglu_hidden) == (
        0, False, None, 0)
    net = vit.ViT(cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == plain_vit_leaves(cfg)
    assert net.num_prefix_tokens == 1
    assert all(not getattr(net, b).layer_scaled for b in net.block_names)
    assert all(isinstance(getattr(net, b).mlp, vit.MlpBlock) for b in net.block_names)


def test_state_dict_names_both_ways():
    prog, ref, weights = pair()
    names = set(prog.state_dict())
    assert names == set(ref.state_dict())
    net = "backbone.backbone.vit."
    block = {n[len(net + "blocks_0."):] for n in names if n.startswith(net + "blocks_0.")}
    assert block == {
        "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
        "attn.proj.bias", "ls1.gamma", "norm2.weight", "norm2.bias", "mlp.fc1.weight",
        "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias", "ls2.gamma"}
    shapes = {k: tuple(v.shape) for k, v in prog.state_dict().items()}
    assert shapes[net + "pos_embed"] == (1, 16, 128)  # the patches only
    assert shapes[net + "reg_token"] == (1, 4, 128)
    assert shapes[net + "blocks_0.mlp.fc1.weight"] == (682, 128)
    assert shapes[net + "blocks_0.mlp.fc2.weight"] == (128, 341)
    # the leaves the benchmark serves in fp32 whatever the model's type
    assert weights[net + "blocks_0.ls1.gamma"].dtype == torch.float32
    assert weights[net + "reg_token"].dtype == torch.float32
    # each side takes the other's state dict whole
    prog.load_state_dict(ref.state_dict(), strict=True)
    ref.load_state_dict(prog.state_dict(), strict=True)


def test_heads_get_the_patches_alone():
    """CLS and the four registers lead the sequence; the heads get the 16
    patch tokens after them, and CLS is the global feature."""
    prog, _, _ = pair()
    bb = prog.backbone.backbone
    assert bb.num_prefix_tokens == 5
    images, _ = images_and_labels()
    anchor = eval_views(images)
    with torch.no_grad():
        tokens = bb.vit(anchor)
        feats = prog.backbone.forward_single(anchor)
    assert tokens.shape == (B, 21, 128)
    assert feats["patch_tokens"].shape == (B, 16, 128)
    assert torch.equal(feats["patch_tokens"], tokens[:, 5:])
    assert torch.equal(feats["global_features"], tokens[:, 0])


# ----------------------------------------------------------------------------
# forward and gradients against the reference
# ----------------------------------------------------------------------------


def test_tokens_and_logits():
    prog, ref, _ = pair()
    images, _ = images_and_labels()
    anchor = eval_views(images)
    with torch.no_grad():
        feats = prog.backbone.forward_single(anchor)
        patch, glob = ref.backbone.backbone.features(ref.tokens(anchor))
    assert rel(feats["patch_tokens"], patch) < TOL_TOKENS
    assert rel(feats["global_features"], glob) < TOL_TOKENS
    infer = make_infer_fn(prog, prog_aug.AugmentConfig(**SPEC["input"]), device="cpu")
    assert rel(infer(images), ref.infer(anchor)) < TOL_LOGITS


@pytest.mark.parametrize("remat", ["none", "block"])
def test_gradients_under_one_train_step(remat):
    prog, ref, _ = pair(remat)
    assert prog.backbone.backbone.vit.config.remat == remat
    images, labels = images_and_labels()
    state = create_train_state(prog, SPEC["port_config"], SPEC["steps_per_epoch"], device="cpu")
    step = make_train_step(prog, prog_aug.AugmentConfig(**SPEC["input"]), device="cpu")
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
                                                     ref_aug.AugmentConfig(**SPEC["input"]))
    ref_loss = float(ref.loss_and_grads(anchor, positive, labels, drop_gen))
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)

    ref_params = dict(ref.named_parameters())
    norms = {n: float(p.grad.norm()) for n, p in ref_params.items()}
    floor = 1e-3 * sorted(norms.values())[len(norms) // 2]
    checked = set()
    for name, _ in prog.named_parameters():
        if norms[name] >= floor:  # leaves with a gradient to speak of
            assert rel(grads[name], ref_params[name].grad) < TOL_GRAD, name
            checked.add(name)
    net = "backbone.backbone.vit."
    assert {net + "reg_token", net + "pos_embed", net + "blocks_1.ls1.gamma",
            net + "blocks_1.ls2.gamma", net + "blocks_0.mlp.fc1.weight"} <= checked
    assert len([n for n in checked if n.startswith(net)]) > 30


def test_spans_only_where_the_options_are_on():
    """A DINOv2 forward records ``swiglu`` once a block and ``layer_scale``
    twice; a plain ViT's records neither."""
    def names(backbone_name, img):
        model = create_model({"model": {"backbone_name": backbone_name,
                                        "moment": {"d_out": 32, "sketch_dim": 64}}},
                             num_classes=10, device="cpu")
        x = torch.randn(1, img, img, 3)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                model.inference(x)
        return [e.name for e in prof.events() if e.name.startswith(PREFIX)]

    spans = names(MICRO, 56)
    assert spans.count(PREFIX + "swiglu") == 2 and spans.count(PREFIX + "layer_scale") == 4
    plain = names("vit_micro_patch16_64", 64)
    assert PREFIX + "swiglu" not in plain and PREFIX + "layer_scale" not in plain
    assert PREFIX + "backbone" in plain


# ----------------------------------------------------------------------------
# faults of the backbone move the logits
# ----------------------------------------------------------------------------


STEM = vit.ViT.stem  # the faults below derive theirs from it


def _layer_scale_left_out(monkeypatch):
    monkeypatch.setattr(vit.LayerScale, "forward", lambda self, x, branch: x + branch)


def _silu_on_the_second_half(monkeypatch):
    def forward(self, x):
        h1, h2 = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(h1 * F.silu(h2))
    monkeypatch.setattr(vit.SwiGLUPacked, "forward", forward)


def _registers_left_out(monkeypatch):
    """``[CLS, patches]``: the registers never enter the sequence, and the
    heads still get every patch."""
    def stem(self, images):
        x = STEM(self, images)
        return torch.cat([x[:, :1], x[:, 1 + self.config.num_registers:]], dim=1)
    monkeypatch.setattr(vit.ViT, "stem", stem)
    monkeypatch.setattr(vit.ViT, "num_prefix_tokens", property(lambda self: 1))


def _pos_embed_on_the_prefix(monkeypatch):
    """The position embedding added to the first N rows of ``[CLS,
    registers, patches]``: shifted onto the prefix, the last patches
    without."""
    def stem(self, images):
        x = self.patch_embed(images.to(self.dtype))
        b, n, d = x.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, d),
                       self.reg_token.to(self.dtype).expand(b, -1, d), x], dim=1)
        return torch.cat([x[:, :n] + self.pos_embed.to(self.dtype), x[:, n:]], dim=1)
    monkeypatch.setattr(vit.ViT, "stem", stem)


FAULTS = {"layer_scale_left_out": _layer_scale_left_out,
          "silu_on_the_second_half": _silu_on_the_second_half,
          "registers_left_out": _registers_left_out,
          "pos_embed_on_the_prefix": _pos_embed_on_the_prefix}


def plant(fault: str, monkeypatch) -> None:
    """Plant a fault in the port's DINOv2 (before the model is built: the
    backbone reads its prefix count at build)."""
    FAULTS[fault](monkeypatch)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_moves_the_logits(monkeypatch, fault):
    out, ref = served()
    assert rel(out, ref) < TOL_LOGITS
    plant(fault, monkeypatch)
    out, ref = served()
    assert rel(out, ref) > 100 * TOL_LOGITS, fault
