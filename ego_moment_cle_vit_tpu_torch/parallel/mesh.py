"""The ('data', 'model') mesh on ``torch.distributed``.

Counterpart of ``ego_moment_cle_vit_tpu/parallel/mesh.py``.  One process per
rank: rank ``r`` sits at mesh position ``(r // model, r % model)``, the layout
of ``np.asarray(devices).reshape(data, model)`` in the JAX package.  The mesh
holds two process groups for its rank: the data group (the ranks of its
column, same model index), over which batches are gathered and gradients
summed, and the model group (the ranks of its row, same data index), over
which a row-parallel product is reduced.

The backend is explicit: a process that joins the world here uses NCCL for
ranks on GPUs and gloo for ranks on the CPU.  A caller that started a gloo
world itself may pass a ``devices`` list such as ``["cuda:0", "cuda:0"]`` to
run several ranks on one card (NCCL refuses two ranks on one GPU; gloo
carries ``all_reduce`` and ``broadcast`` on CUDA tensors through the host).
Without a list, rank ``r`` takes ``cuda:{LOCAL_RANK}``; the mesh never puts
ranks on the CPU on its own.
Every group gets a timeout, so a rank that dies fails its peers' collectives
instead of hanging them.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["DEFAULT_TIMEOUT", "Mesh", "create_mesh", "local_device_count", "mesh_shape"]

DEFAULT_TIMEOUT = timedelta(minutes=10)


def local_device_count() -> int:
    """GPUs attached to this host (the ranks a host can give a card each)."""
    return torch.cuda.device_count()


def mesh_shape(data: Optional[int], model: int, n: int) -> tuple:
    """(data, model) of a mesh over ``n`` ranks: ``data=None`` is ``n //
    model``; raises unless ``data * model == n``."""
    model = int(model)
    data = n // model if data is None else int(data)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices; pass matching sizes")
    return data, model


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a ``data x model`` mesh: its position, its device
    and the two groups it belongs to."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model



def create_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
    *,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Mesh:
    """Build this rank's ('data', 'model') mesh over the world's processes.

    Joins the default process group first if the process has none, NCCL
    for GPU ranks and gloo for CPU ranks: rank and world size then come from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  ``data=None`` means ``world_size // model``; ``data *
    model`` must equal the world size.  ``devices`` lists one device per
    rank; without it rank ``r`` takes ``cuda:{LOCAL_RANK}`` and raises if the
    host has fewer GPUs.
    """
    if devices is None:
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                        else 0))
        if local_rank >= local_device_count():
            raise RuntimeError(
                f"local rank {local_rank} has no GPU ({local_device_count()} on this host); "
                "pass devices=[...] (e.g. 'cpu' for every rank) to place the ranks")
        device = torch.device("cuda", local_rank)
    if not dist.is_initialized():
        first = torch.device(devices[0]) if devices is not None else device
        dist.init_process_group("nccl" if first.type == "cuda" else "gloo", timeout=timeout)
    n = dist.get_world_size()
    rank = dist.get_rank()
    data, model = mesh_shape(data, model, n)
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for a world of {n} ranks")
        device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # every rank creates every group, in the same order
    data_groups = [dist.new_group([d * model + m for d in range(data)], timeout=timeout)
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)], timeout=timeout)
                    for d in range(data)]
    return Mesh(data, model, rank, device, data_groups[rank % model],
                model_groups[rank // model])
