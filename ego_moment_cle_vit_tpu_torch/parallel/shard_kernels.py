"""Kernels and batch-mixing layers on a mesh.

Counterpart of ``ego_moment_cle_vit_tpu/parallel/shard_kernels.py``.  In the
JAX package GSPMD compiles one global program and cannot partition a
``pallas_call``, so each kernel call site is wrapped in ``shard_map`` to run
on its shard's rows.  Here every rank is its own process and already
launches every kernel (1/1b, 2/2b, 3/3b, 4/4b, 5/5′/5″, 6/6b) on its local
rows: all of them are batch-parallel, so a kernel on a shard is the
one-device kernel on ``B / data`` samples, and nothing wraps them.  Their
replicated operands (GPF coefficients, bias tables) get their gradients
summed over ``data`` with every other parameter's (``train/step.py``).

``EMCT_KERNEL_SPMD=off`` has no counterpart: it selects the JAX package's XLA
path in place of the kernels, and the port has no path that falls back from a
kernel.

What does need the mesh are the layers that mix samples across the batch:
BatchNorm's batch statistics, the dropout draw (the masks of the global batch,
each rank keeping its rows) and the loss terms.  They read the mesh
registered here, with the rank's local batch, while a step runs
(``kernel_mesh``); with none registered they run the one-device code.  The
registration is process-wide (one process is one rank), so a forward that
autograd recomputes in its backward thread under checkpointing sees it too.
"""

from __future__ import annotations

import contextlib
import types
from typing import Optional, Tuple

__all__ = ["active_kernel_mesh", "check_local_batch", "kernel_mesh", "local_rows"]

_STATE = types.SimpleNamespace(mesh=None, local_batch=None)


@contextlib.contextmanager
def kernel_mesh(mesh, local_batch: Optional[int] = None):
    """Register the mesh (None: one device) and this rank's local batch
    while the block runs."""
    prev = (_STATE.mesh, _STATE.local_batch)
    _STATE.mesh, _STATE.local_batch = mesh, local_batch
    try:
        yield
    finally:
        _STATE.mesh, _STATE.local_batch = prev


def active_kernel_mesh():
    """The registered mesh (whatever its size: a 1 x 1 mesh still runs the
    mesh code), or None."""
    return _STATE.mesh


def local_rows(leading: int) -> Tuple[int, int]:
    """For a tensor of ``leading`` local rows under the registered mesh: (k,
    b), where the rows are ``k`` blocks of the rank's ``b`` samples (k = 2 for
    the dual-view backbone's [anchor; positive] batch)."""
    b = _STATE.local_batch
    if b is None or leading % b:
        raise ValueError(f"{leading} rows under a mesh whose local batch is {b}")
    return leading // b, b


def check_local_batch(batch: int, mesh) -> int:
    """The local batch of a global ``batch`` on ``mesh``'s data axis: every
    data rank takes the same number of rows."""
    if batch % mesh.data:
        raise ValueError(f"batch {batch} does not divide the mesh's data axis ({mesh.data})")
    return batch // mesh.data
