"""Sharding rules: batches over 'data', the big projections' fan-in over 'model'.

Counterpart of ``ego_moment_cle_vit_tpu/parallel/sharding.py``, over the
port's parameter names.  The moment head's ``second_proj`` (fan-in
D(D+1)/2: 1.18M x 512 at Swin-Large), ``third_proj`` and the classifier's
``fc1`` have their fan-in split over the model axis: each model rank keeps a
block of the input columns, multiplies its block of the input, and the
partial products are summed over the model group (``models/layers.py``,
``Dense``'s row-parallel form).  Every other leaf is replicated.

A spec is a tuple with one entry per dimension, an axis name or None (the
JAX ``PartitionSpec``); ``()`` is replicated.  The port's ``Dense`` weight is
``[out, in]``, so the fan-in is dimension 1 where the flax kernel has it at 0,
and the bias stays replicated.  A leaf whose dimension does not divide the
axis is replicated (JAX ``_spec_fits``).

``gather_params`` / ``load_params`` carry a sharded model to and from the
one-device ``state_dict`` (checkpoints); the optimizer does the same for its
state (``train/state.py``).  Batches shard over 'data' by rows
(``data/pipeline.py:shard_batch``, the JAX ``batch_sharding``'s layout).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from .collectives import all_reduce_sum

__all__ = [
    "DEFAULT_RULES",
    "gather_params",
    "load_params",
    "param_sharding_rules",
    "param_specs",
    "replicate",
    "shard_params",
    "sharded_params",
    "unshard",
]

Spec = Tuple

# (regex over the parameter name, spec); the first match wins
DEFAULT_RULES: Tuple[Tuple[str, Spec], ...] = (
    # moment head: the huge half-vectorized projection, its fan-in sharded
    (r".*moment_head\.second_proj\.weight$", (None, "model")),
    (r".*moment_head\.third_proj\.weight$", (None, "model")),
    # the classifier's first layer has fan-in d_cls + d_moment
    (r".*classifier\.fc1\.weight$", (None, "model")),
    # everything else replicated
    (r".*", ()),
)


def param_sharding_rules(name: str, rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, name):
            return spec
    return ()


def _spec_fits(shape, spec: Spec, mesh) -> bool:
    """A spec applies only if the leaf has enough dimensions and every
    partitioned one divides by its axis's size."""
    if len(spec) > len(shape):
        return False
    if mesh is not None:
        for dim, axis in enumerate(spec):
            size = mesh.shape.get(axis, 1) if axis is not None else 1
            if size > 1 and shape[dim] % size:
                return False
    return True


def param_specs(model: torch.nn.Module, mesh=None,
                rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES) -> Dict[str, Spec]:
    """{parameter name: spec} of the model's (unsharded) parameters, a spec
    that does not fit replaced by ``()``."""
    specs = {}
    for name, p in model.named_parameters():
        spec = param_sharding_rules(name, rules)
        specs[name] = spec if spec and _spec_fits(p.shape, spec, mesh) else ()
    return specs


def _sharded_dim(spec: Spec, mesh) -> int | None:
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.shape.get(axis, 1) > 1:
            if axis != "model":
                raise ValueError(f"parameters shard over 'model' only, not {axis!r}")
            return dim
    return None


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh,
                 rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES) -> Dict[str, int]:
    """Shard the model in place by the rules: each sharded weight keeps this
    model rank's block of its fan-in and its ``Dense`` switches to the
    row-parallel form.  Call before the optimizer binds the parameters.
    Returns {name: sharded dimension} (empty on a model axis of 1)."""
    from ..models.layers import Dense

    sharded = {}
    modules = dict(model.named_modules())
    for name, spec in param_specs(model, mesh, rules).items():
        dim = _sharded_dim(spec, mesh)
        if dim is None:
            continue
        prefix, leaf = name.rsplit(".", 1)
        mod = modules[prefix]
        if not isinstance(mod, Dense) or leaf != "weight" or dim != 1:
            raise ValueError(f"{name}: only a Dense weight's fan-in can be sharded")
        mod.shard_fan_in(mesh)
        sharded[name] = dim
    return sharded


def sharded_params(model: torch.nn.Module) -> Dict[str, int]:
    """{name: sharded dimension} of a model that ``shard_params`` sharded."""
    from ..models.layers import Dense

    return {f"{prefix}.weight": 1 for prefix, mod in model.named_modules()
            if isinstance(mod, Dense) and mod.fan_in_shard is not None}


def unshard(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The whole tensor from every model rank's block along ``dim``: the
    blocks written into a zero tensor and summed over the model group (exact),
    in fp32 for bf16."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.model
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, mesh.model_index * n, n).copy_(x)
    return all_reduce_sum(full, mesh.model_group)


def block(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model rank's block of ``x`` along ``dim``."""
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_index * n, n).contiguous()


@torch.no_grad()
def gather_params(model: torch.nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` in the one-device format (parameters and
    buffers), its sharded weights put back together.  Every rank of the mesh
    must call it; every rank gets the whole."""
    sharded = sharded_params(model)
    return {k: unshard(v, sharded[k], mesh) if k in sharded else v
            for k, v in model.state_dict().items()}


@torch.no_grad()
def load_params(model: torch.nn.Module, state: Mapping[str, torch.Tensor], mesh=None) -> None:
    """Load a one-device ``state_dict`` into a model, sharded or not: a
    sharded weight takes this rank's block."""
    sharded = sharded_params(model) if mesh is not None else {}
    model.load_state_dict({k: block(v, sharded[k], mesh) if k in sharded else v
                           for k, v in state.items()})


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh) -> None:
    """Make every rank's parameters and buffers rank 0's: a broadcast over the
    world (bf16 through fp32, exact)."""
    for t in list(model.parameters()) + list(model.buffers()):
        if t.dtype == torch.bfloat16:
            buf = t.float()
            dist.broadcast(buf, src=0)
            t.copy_(buf)
        else:
            dist.broadcast(t.data, src=0)
