"""flax variables (numpy) <-> the port's named tensors.

The reverse direction of ``ego_moment_cle_vit_tpu/utils/port_weights.py``.
The port's module tree mirrors the flax tree name for name, so a flax path
``params/backbone/backbone/swin/stage0_block0/attn/qkv/kernel`` becomes
``backbone.backbone.swin.stage0_block0.attn.qkv.weight``, with:

* Dense kernels ``[in, out]`` -> ``weight`` ``[out, in]`` (transposed);
* conv kernels ``[kh, kw, I, O]`` -> ``weight`` ``[O, I, kh, kw]``;
* flax ``DenseGeneral`` kernels (the multi-scale head's attention, ``[C, 1,
  C]`` / ``[1, C, C]``) -> ``weight [out, in]``, their biases flattened;
* LayerNorm and BatchNorm ``scale`` -> ``weight``; the flax ``LayerNorm_0`` /
  ``BatchNorm_0`` level of the head norms is dropped;
* ``batch_stats`` ``mean`` / ``var`` -> the BatchNorm buffers
  ``running_mean`` / ``running_var``;
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


_NORM_LEVELS = ("LayerNorm_0", "BatchNorm_0")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def _port_key(path: tuple) -> str:
    parts = [p for p in path[1:] if p not in _NORM_LEVELS]  # drop the collection
    parts[-1] = _LEAF_NAMES.get(parts[-1], parts[-1])
    return ".".join(parts)


def _dense_general(model: torch.nn.Module) -> Dict[str, tuple]:
    """{module prefix: (flax kernel shape, input axes)} of the Dense modules
    that stand for a flax DenseGeneral."""
    from ..models.layers import Dense  # here: models imports utils

    return {prefix: (mod.flax_kernel_shape, mod.flax_in_axes)
            for prefix, mod in model.named_modules()
            if isinstance(mod, Dense) and mod.flax_kernel_shape is not None}


def _port_value(path: tuple, value: np.ndarray, general: Dict[str, tuple]) -> np.ndarray:
    prefix = ".".join(p for p in path[1:-1] if p not in _NORM_LEVELS)
    if prefix in general:
        kshape, in_axes = general[prefix]
        if path[-1] == "kernel":
            return value.reshape(int(np.prod(kshape[:in_axes])), -1).T
        return value.reshape(-1)
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
    """Map numpy flax ``{"params", "batch_stats", "constants"}`` onto
    ``model``'s entries.

    Returns a state dict on ``device`` (raises without a GPU unless
    ``device='cpu'``) in the model's dtypes, ready for
    ``model.load_state_dict``.
    """
    dev = resolve_device(device)
    target = model.state_dict()
    general = _dense_general(model)
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, value in _flatten(variables).items():
        if path[0] not in ("params", "batch_stats", "constants"):
            raise KeyError(f"unexpected flax collection {path[0]!r}")
        key = _port_key(path)
        if key not in target:
            unused.append("/".join(path))
            continue
        arr = np.ascontiguousarray(_port_value(path, value, general))
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
    (parameters, their gradients, or anything else of those shapes), and may
    hold the BatchNorm buffers too.  Dense ``weight [out, in]`` -> ``kernel
    [in, out]`` (a DenseGeneral's reshaped to its flax kernel, its bias to
    the kernel's output axes); conv ``weight [O, I, kh, kw]`` -> ``kernel
    [kh, kw, I, O]``; LayerNorm / BatchNorm ``weight`` -> ``scale``, with the
    ``LayerNorm_0`` / ``BatchNorm_0`` level restored under the head norms;
    ``running_mean`` / ``running_var`` -> ``mean`` / ``var`` in
    ``batch_stats``.  ``model`` only tells the kind of each module.  Returns
    ``{"params": tree}``, with ``"batch_stats"`` beside it when given any.
    """
    from ..models.layers import BatchNorm, Dense, LayerNorm  # here: models imports utils

    kinds = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, Dense):
            kinds[prefix] = "dense"
        elif isinstance(mod, torch.nn.Conv2d):
            kinds[prefix] = "conv"
        elif isinstance(mod, LayerNorm):
            kinds[prefix] = "head_norm" if getattr(mod, "flax_level", None) else "norm"
        elif isinstance(mod, BatchNorm):
            kinds[prefix] = "batch_norm"
    general = _dense_general(model)
    trees: Dict[str, Dict[str, Any]] = {"params": {}}
    for name, value in named.items():
        value = np.asarray(value)
        prefix, _, leaf = name.rpartition(".")
        kind = kinds.get(prefix)
        path = prefix.split(".") if prefix else []
        if kind == "head_norm":
            path.append("LayerNorm_0")
        elif kind == "batch_norm":
            path.append("BatchNorm_0")
        collection = "params"
        if leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf[len("running_"):]
        elif prefix in general:
            kshape, in_axes = general[prefix]
            if leaf == "weight":
                leaf, value = "kernel", value.T.reshape(kshape)
            else:
                value = value.reshape(kshape[in_axes:])
        elif leaf == "weight":
            if kind == "dense":
                leaf, value = "kernel", value.T
            elif kind == "conv":
                leaf, value = "kernel", value.transpose(2, 3, 1, 0)
            elif kind in ("norm", "head_norm", "batch_norm"):
                leaf = "scale"
            else:
                raise KeyError(f"{name}: a 'weight' outside Dense, Conv2d and the norms")
        node = trees.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return trees
