"""The port's timm conversion against the JAX package's.

timm-style state dicts are built here as ``tests/test_port_weights.py``
builds them: ViT at ``vit_micro_patch16_64`` and Swin at
``swin_micro_patch4_window7_56`` in both timm layouts (the patch merging at
the start of the next stage, or at the end of its own).  The port converts
and splices them into a model's ``state_dict``; the JAX package converts and
splices them into the flax tree of the same model, and
``torch_state_dict_from_flax`` carries that tree across.  The two must agree
on every key, bit for bit, in fp32 and with bf16 weights.  Also: the splice's
checks, and ``interpolate_pos_embed`` against the JAX one (a bicubic resample;
its products sum in another order, so 1e-6 of the largest entry).
"""

import numpy as np
import pytest
import torch

from ego_moment_cle_vit_tpu.utils import port_weights as jpw
from ego_moment_cle_vit_tpu_torch import create_model
from ego_moment_cle_vit_tpu_torch.utils import port_weights as tpw
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)

torch.set_num_threads(1)


def _t(g, *shape):
    return torch.randn(*shape, generator=g) * 0.05


def _vit_sd(dim=64, depth=2, patch=16, grid=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {
        "cls_token": _t(g, 1, 1, dim),
        "pos_embed": _t(g, 1, grid * grid + 1, dim),
        "patch_embed.proj.weight": _t(g, dim, 3, patch, patch),
        "patch_embed.proj.bias": _t(g, dim),
        "norm.weight": 1 + _t(g, dim),
        "norm.bias": _t(g, dim),
    }
    for i in range(depth):
        p = f"blocks.{i}"
        for name, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)),
                            ("norm2.weight", (dim,)), ("norm2.bias", (dim,)),
                            ("attn.qkv.weight", (3 * dim, dim)), ("attn.qkv.bias", (3 * dim,)),
                            ("attn.proj.weight", (dim, dim)), ("attn.proj.bias", (dim,)),
                            ("mlp.fc1.weight", (4 * dim, dim)), ("mlp.fc1.bias", (4 * dim,)),
                            ("mlp.fc2.weight", (dim, 4 * dim)), ("mlp.fc2.bias", (dim,))):
            sd[f"{p}.{name}"] = _t(g, *shape)
    return sd


def _swin_sd(older_layout: bool, dim=128, heads=(4, 8), ws=7, seed=1):
    g = torch.Generator().manual_seed(seed)
    sd = {
        "patch_embed.proj.weight": _t(g, dim, 3, 4, 4),
        "patch_embed.proj.bias": _t(g, dim),
        "patch_embed.norm.weight": 1 + _t(g, dim),
        "patch_embed.norm.bias": _t(g, dim),
        "norm.weight": 1 + _t(g, 2 * dim),
        "norm.bias": _t(g, 2 * dim),
    }
    for s, (d, h) in enumerate(zip((dim, 2 * dim), heads)):
        p = f"layers.{s}.blocks.0"
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
                            ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
                            ("attn.relative_position_bias_table", ((2 * ws - 1) ** 2, h)),
                            ("mlp.fc1.weight", (4 * d, d)), ("mlp.fc1.bias", (4 * d,)),
                            ("mlp.fc2.weight", (d, 4 * d)), ("mlp.fc2.bias", (d,))):
            sd[f"{p}.{name}"] = _t(g, *shape)
    # the one patch merging, between stages 0 and 1
    ds = "layers.0.downsample" if older_layout else "layers.1.downsample"
    sd[f"{ds}.norm.weight"] = 1 + _t(g, 4 * dim)
    sd[f"{ds}.norm.bias"] = _t(g, 4 * dim)
    sd[f"{ds}.reduction.weight"] = _t(g, 2 * dim, 4 * dim)
    return sd


def _model(backbone: str, size: int, bf16: bool):
    cfg = {"model": {"backbone_name": backbone, "bf16": bf16,
                     "moment": {"d_out": 32, "sketch_dim": 128}},
           "data": {"input_size": size}}
    return create_model(cfg, num_classes=5, device="cpu", seed=3)


def _flax_variables(model):
    """The port model's weights as flax variables (params and constants)."""
    named = {n: p.detach().float().numpy() for n, p in model.named_parameters()}
    return {**flax_tree_from_named_tensors(named, model),
            "constants": {"moment_head": {
                "sketch_matrices": model.moment_head.sketch_matrices.numpy()}}}


CASES = [
    ("vit", "vit_micro_patch16_64", 64, lambda: _vit_sd(), jpw.convert_vit_state_dict,
     tpw.convert_vit_state_dict),
    ("swin", "swin_micro_patch4_window7_56", 56, lambda: _swin_sd(older_layout=False),
     jpw.convert_swin_state_dict, tpw.convert_swin_state_dict),
    ("swin", "swin_micro_patch4_window7_56", 56, lambda: _swin_sd(older_layout=True),
     jpw.convert_swin_state_dict, tpw.convert_swin_state_dict),
]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("family,backbone,size,make_sd,j_convert,t_convert", CASES,
                         ids=["vit", "swin_newer_timm", "swin_older_timm"])
def test_conversion_equals_jax_through_torch_state_dict_from_flax(
        family, backbone, size, make_sd, j_convert, t_convert, bf16):
    sd = make_sd()
    model = _model(backbone, size, bf16)
    got = tpw.splice_backbone_params(model.state_dict(), t_convert(sd), family)

    variables = _flax_variables(model)
    variables["params"] = jpw.splice_backbone_params(variables["params"], j_convert(sd), family)
    ref = torch_state_dict_from_flax(variables, model, device="cpu")

    assert sorted(got) == sorted(ref) == sorted(model.state_dict())
    prefix = f"backbone.backbone.{family}."
    spliced = [k for k in ref if k.startswith(prefix)]
    assert len(spliced) == len(t_convert(sd)) > 10
    for key in ref:
        assert got[key].dtype == ref[key].dtype == model.state_dict()[key].dtype, key
        assert torch.equal(got[key], ref[key]), key
    model.load_state_dict(got)  # the spliced dict loads as it is
    # the patch merging landed on the boundary it belongs to
    if family == "swin":
        ds = ("layers.0.downsample" if "layers.0.downsample.norm.weight" in sd
              else "layers.1.downsample")
        w = got[prefix + "stage0_downsample.reduction.weight"]
        assert torch.equal(w, sd[f"{ds}.reduction.weight"].to(w.dtype))


def test_splice_checks_shapes_and_keys():
    model = _model("swin_micro_patch4_window7_56", 56, False)
    state = model.state_dict()
    conv = tpw.convert_swin_state_dict(_swin_sd(older_layout=False))
    bad = dict(conv)
    bad["stage0_block0.attn.qkv.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        tpw.splice_backbone_params(state, bad, "swin")
    missing = {k: v for k, v in conv.items() if k != "norm.bias"}
    with pytest.raises(ValueError, match="missing"):
        tpw.splice_backbone_params(state, missing, "swin")
    extra = {**conv, "stage9_block0.norm1.weight": torch.zeros(1)}
    with pytest.raises(ValueError, match="lacks"):
        tpw.splice_backbone_params(state, extra, "swin")
    with pytest.raises(ValueError, match="no 'vit' backbone"):
        tpw.splice_backbone_params(state, conv, "vit")
    # the JAX splice refuses the same wrong shape
    variables = _flax_variables(model)
    jbad = jpw.convert_swin_state_dict(_swin_sd(older_layout=False))
    jbad["stage0_block0"]["attn"]["qkv"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        jpw.splice_backbone_params(variables["params"], jbad, "swin")


def test_splice_resamples_a_vit_position_embedding_like_jax(tmp_path):
    """A 224-grid (14 x 14) checkpoint spliced into the 64-input ViT
    (4 x 4): the position embedding is resampled on both sides, and
    load_torch_backbone reads a saved state_dict file."""
    sd = _vit_sd(grid=14)
    path = tmp_path / "timm_vit.pth"
    torch.save({"state_dict": sd}, path)
    model = _model("vit_micro_patch16_64", 64, False)
    got = tpw.splice_backbone_params(
        model.state_dict(), tpw.load_torch_backbone("vit_micro_patch16_64", str(path)), "vit")
    variables = _flax_variables(model)
    variables["params"] = jpw.splice_backbone_params(
        variables["params"], jpw.load_torch_backbone("vit_micro_patch16_64", str(path)), "vit")
    ref = torch_state_dict_from_flax(variables, model, device="cpu")
    key = "backbone.backbone.vit.pos_embed"
    assert got[key].shape == (1, 17, 64)
    scale = ref[key].abs().max().item()
    assert (got[key] - ref[key]).abs().max().item() <= 1e-6 * scale
    for k in ref:
        if k != key:
            assert torch.equal(got[k], ref[k]), k
    with pytest.raises(ValueError, match="No converter"):
        tpw.load_torch_backbone("resnet50", str(path))


@pytest.mark.parametrize("n_old,n_new", [(16, 64), (196, 16), (196, 784), (16, 16)])
def test_interpolate_pos_embed_matches_jax(n_old, n_new):
    rng = np.random.default_rng(n_old + n_new)
    pe = rng.standard_normal((1, 1 + n_old, 8)).astype(np.float32)
    ref = jpw.interpolate_pos_embed(pe, n_new)
    got = tpw.interpolate_pos_embed(torch.from_numpy(pe), n_new).numpy()
    assert got.shape == ref.shape == (1, 1 + n_new, 8)
    np.testing.assert_array_equal(got[:, 0], pe[:, 0])  # CLS untouched
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    with pytest.raises(ValueError, match="non-square"):
        tpw.interpolate_pos_embed(torch.from_numpy(pe), 15)
