"""flax variables (numpy) <-> the port's named tensors.

The reverse direction of ``ego_moment_cle_vit_tpu/utils/port_weights.py``.
The port's module tree mirrors the flax tree name for name, so a flax path
``params/backbone/backbone/swin/stage0_block0/attn/qkv/kernel`` becomes
``backbone.backbone.swin.stage0_block0.attn.qkv.weight``, with:

* Dense kernels ``[in, out]`` -> ``weight`` ``[out, in]`` (transposed);
* conv kernels ``[kh, kw, I, O]`` -> ``weight`` ``[O, I, kh, kw]``;
* LayerNorm ``scale`` -> ``weight``; the flax ``LayerNorm_0`` level of the
  head norms is dropped;
* ``constants/moment_head/sketch_matrices`` -> the head's buffer, so a
  converted model uses the JAX count-sketch draw.

Every converted tensor takes the dtype of the model's own entry.  Any flax
leaf without a port entry, or port entry without a flax leaf, raises.

``flax_tree_from_named_tensors`` is the inverse for names and layouts, so the
port's parameters, gradients or updated parameters can be laid beside a flax
``params`` tree leaf by leaf.  Both directions take and return numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .device import resolve_device


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _port_key(path: tuple) -> str:
    parts = [p for p in path[1:] if p != "LayerNorm_0"]  # drop the collection
    leaf = parts[-1]
    if leaf in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _port_value(path: tuple, value: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if value.ndim == 2:
            return value.T
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.ndim} at {'/'.join(path)}")
    return value


def torch_state_dict_from_flax(
    variables: Mapping[str, Any], model: torch.nn.Module, *,
    device: str | torch.device = "cuda",
) -> Dict[str, torch.Tensor]:
    """Map numpy flax ``{"params", "constants"}`` onto ``model``'s entries.

    Returns a state dict on ``device`` (raises without a GPU unless
    ``device='cpu'``) in the model's dtypes, ready for
    ``model.load_state_dict``.
    """
    dev = resolve_device(device)
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in _flatten(variables).items():
        if path[0] not in ("params", "constants"):
            raise KeyError(f"unexpected flax collection {path[0]!r}")
        key = _port_key(path)
        if key not in target:
            unused.append("/".join(path))
            continue
        arr = np.ascontiguousarray(_port_value(path, value))
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(
                f"{'/'.join(path)} -> {key}: shape {arr.shape} != {tuple(target[key].shape)}"
            )
        out[key] = torch.from_numpy(arr.astype(np.float32)).to(dev, target[key].dtype)
    missing = sorted(set(target) - set(out))
    if unused or missing:
        raise KeyError(f"flax leaves without a port entry: {unused}; "
                       f"port entries without a flax leaf: {missing}")
    return out


def flax_tree_from_named_tensors(
    named: Mapping[str, np.ndarray], model: torch.nn.Module
) -> Dict[str, Any]:
    """Lay tensors named like ``model.named_parameters()`` out as a flax
    ``params`` tree: nested dicts, flax leaf names and layouts.

    ``named`` maps parameter names to numpy arrays in the port's layouts
    (parameters, their gradients, or anything else of those shapes).  Dense
    ``weight [out, in]`` -> ``kernel [in, out]``; conv ``weight [O, I, kh,
    kw]`` -> ``kernel [kh, kw, I, O]``; LayerNorm ``weight`` -> ``scale``, with
    the ``LayerNorm_0`` level restored under the head norms.  ``model`` only
    tells the kind of each module.  Returns ``{"params": tree}``.
    """
    from ..models.layers import Dense, LayerNorm  # here: models imports utils

    kinds = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, Dense):
            kinds[prefix] = "dense"
        elif isinstance(mod, torch.nn.Conv2d):
            kinds[prefix] = "conv"
        elif isinstance(mod, LayerNorm):
            kinds[prefix] = "norm"
    tree: Dict[str, Any] = {}
    for name, value in named.items():
        value = np.asarray(value)
        prefix, _, leaf = name.rpartition(".")
        kind = kinds.get(prefix)
        path = prefix.split(".") if prefix else []
        if kind == "norm" and path[0] in ("moment_head", "classifier"):
            path.append("LayerNorm_0")
        if leaf == "weight":
            if kind == "dense":
                leaf, value = "kernel", value.T
            elif kind == "conv":
                leaf, value = "kernel", value.transpose(2, 3, 1, 0)
            elif kind == "norm":
                leaf = "scale"
            else:
                raise KeyError(f"{name}: a 'weight' outside Dense, Conv2d and LayerNorm")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return {"params": tree}
