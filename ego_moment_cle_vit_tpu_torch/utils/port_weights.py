"""timm backbone ``state_dict`` -> the port's ``state_dict``.

The port's counterpart of ``ego_moment_cle_vit_tpu/utils/port_weights.py``.
A timm model's ``state_dict()`` saved with ``torch.save`` is renamed onto the
port's backbone module, whose names follow the flax tree:

* ViT: ``blocks.{i}.attn.qkv`` -> ``blocks_{i}.attn.qkv``; everything else
  keeps its name.
* Swin: ``patch_embed.proj`` -> ``patch_embed_proj``,
  ``layers.{s}.blocks.{b}.mlp.fc1`` -> ``stage{s}_block{b}.mlp_fc1``, and the
  patch merging, which newer timm keeps at the START of stage s+1
  (``layers.{s+1}.downsample``) and older timm at the END of stage s
  (``layers.{s}.downsample``), -> ``stage{s}_downsample``.

torch Linear and Conv2d weights already have the port's layouts, so nothing
is transposed.  The keys returned are relative to the backbone slot
``backbone.backbone.{vit|swin}.``; ``splice_backbone_params`` puts them into
a model's ``state_dict``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..ops.resize import resize


def _t(x) -> torch.Tensor:
    """torch tensor / array -> fp32 CPU tensor."""
    x = x.detach() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.cpu().float()


def _copy(sd, src: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    """``{src}.weight`` / ``{src}.bias`` (where present) -> ``{dst}.*``."""
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def convert_vit_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """timm ViT/DeiT state_dict -> the port ViT's entries."""
    depth = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k)))
    out = {"cls_token": _t(sd["cls_token"]), "pos_embed": _t(sd["pos_embed"])}
    _copy(sd, "patch_embed.proj", "patch_embed.proj", out)
    for i in range(depth):
        for part in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            _copy(sd, f"blocks.{i}.{part}", f"blocks_{i}.{part}", out)
    _copy(sd, "norm", "norm", out)
    return out


def convert_swin_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """timm Swin state_dict (either layout) -> the port Swin's entries."""
    stage_depths: Dict[int, int] = {}
    for k in sd:
        m = re.match(r"layers\.(\d+)\.blocks\.(\d+)\.", k)
        if m:
            s, b = int(m.group(1)), int(m.group(2))
            stage_depths[s] = max(stage_depths.get(s, 0), b + 1)
    num_stages = len(stage_depths)

    out: Dict[str, torch.Tensor] = {}
    _copy(sd, "patch_embed.proj", "patch_embed_proj", out)
    _copy(sd, "patch_embed.norm", "patch_embed_norm", out)
    _copy(sd, "norm", "norm", out)
    for s in range(num_stages):
        for b in range(stage_depths[s]):
            src, dst = f"layers.{s}.blocks.{b}", f"stage{s}_block{b}"
            for part, name in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.qkv", "attn.qkv"),
                               ("attn.proj", "attn.proj"), ("mlp.fc1", "mlp_fc1"),
                               ("mlp.fc2", "mlp_fc2")):
                _copy(sd, f"{src}.{part}", f"{dst}.{name}", out)
            out[f"{dst}.attn.relative_position_bias_table"] = _t(
                sd[f"{src}.attn.relative_position_bias_table"])
    # Detect the layout once for all boundaries: layers.1.downsample exists in
    # both layouts but belongs to different boundaries, and a per-stage
    # preference would map older-layout weights one stage off.
    older_layout = "layers.0.downsample.norm.weight" in sd
    for s in range(num_stages - 1):
        cand = f"layers.{s}.downsample" if older_layout else f"layers.{s + 1}.downsample"
        if f"{cand}.norm.weight" in sd:
            _copy(sd, f"{cand}.norm", f"stage{s}_downsample.norm", out)
            out[f"stage{s}_downsample.reduction.weight"] = _t(sd[f"{cand}.reduction.weight"])
    return out


def interpolate_pos_embed(pos_embed, target_num_patches: int) -> torch.Tensor:
    """Resize a ViT position embedding [1, 1+N, D] to another patch count by
    bicubic resampling of its grid (the CLS entry kept), with the weights of
    ``jax.image.resize(..., "cubic")``: how a 224 checkpoint serves a 448
    input."""
    pos_embed = _t(pos_embed)
    cls_tok, grid = pos_embed[:, :1], pos_embed[:, 1:]
    n_old = grid.shape[1]
    side_old = int(round(n_old**0.5))
    side_new = int(round(target_num_patches**0.5))
    if side_old * side_old != n_old or side_new * side_new != target_num_patches:
        raise ValueError(f"non-square patch grids: {n_old} -> {target_num_patches}")
    if side_old == side_new:
        return pos_embed
    d = grid.shape[-1]
    g = resize(grid.reshape(1, side_old, side_old, d), (1, side_new, side_new, d), "cubic")
    return torch.cat([cls_tok, g.reshape(1, side_new * side_new, d)], dim=1)


def load_torch_backbone(model_name: str, checkpoint_path: str) -> Dict[str, torch.Tensor]:
    """Load a timm state_dict file and convert it for the named backbone."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if model_name.startswith(("vit", "deit")):
        return convert_vit_state_dict(sd)
    if model_name.startswith("swin"):
        return convert_swin_state_dict(sd)
    raise ValueError(f"No converter for backbone family of '{model_name}'")


def splice_backbone_params(model_state: Mapping[str, torch.Tensor],
                           backbone_params: Mapping[str, torch.Tensor],
                           family: str) -> Dict[str, torch.Tensor]:
    """A copy of ``model_state`` (a model's ``state_dict``) with the backbone
    entries replaced by ``backbone_params``, each cast to the model entry's
    dtype and device.  Every backbone entry of the model must be given, with
    its shape (a ViT position embedding of another grid is resampled first);
    a converted entry the model lacks raises too."""
    prefix = f"backbone.backbone.{family}."
    slot = {k[len(prefix):]: v for k, v in model_state.items() if k.startswith(prefix)}
    if not slot:
        raise ValueError(f"the model has no {family!r} backbone")
    backbone_params = dict(backbone_params)
    if (family == "vit" and "pos_embed" in backbone_params
            and tuple(backbone_params["pos_embed"].shape) != tuple(slot["pos_embed"].shape)):
        backbone_params["pos_embed"] = interpolate_pos_embed(
            backbone_params["pos_embed"], slot["pos_embed"].shape[1] - 1)
    missing = sorted(set(slot) - set(backbone_params))
    if missing:
        raise ValueError(f"converted checkpoint missing {missing[:5]} ({len(missing)} entries)")
    unused = sorted(set(backbone_params) - set(slot))
    if unused:
        raise ValueError(f"converted checkpoint has entries the model lacks: {unused[:5]}")
    out = dict(model_state)
    for key, old in slot.items():
        new = backbone_params[key]
        if tuple(old.shape) != tuple(new.shape):
            raise ValueError(f"shape mismatch at {key}: model {tuple(old.shape)} vs ckpt "
                             f"{tuple(new.shape)}")
        out[prefix + key] = _t(new).to(old.device, old.dtype)
    return out
