"""The collectives the model needs on a mesh, as autograd functions.

The JAX package gets these from GSPMD, which compiles one global program;
here each rank runs its own rows and the functions below put back what a
one-device step would have computed.  Only ``all_reduce`` and ``broadcast``
are used: gloo carries both on CUDA tensors, so one code path runs under
gloo on the CPU, under gloo with several ranks on one card, and under NCCL.

Reduction dtype: floating tensors are reduced in fp32 (fp64 stays fp64),
integers in int64, and the result is cast back to the input's dtype.  A bf16
tensor is therefore summed in fp32 and rounded once.

Gradients (each rank computes the same global loss ``L`` from gathered
tensors; ``x_r`` is rank ``r``'s input):

* ``copy_to_model``: ``y = x`` on every model rank, which then multiplies
  its own block of the fan-in.  Each rank's ``dL/dx`` holds only its block's
  columns, so the backward sums it over the model group.
* ``reduce_from_model``: ``y = sum_r x_r`` over the model group (the partial
  products of a row-parallel ``Dense``).  ``dy`` is the same on every model
  rank, and ``dy/dx_r = I``, so the backward is the identity.
* ``gather_batch``: ``y = [x_0; x_1; ...]`` over the data group, written as
  each rank's rows in a zero buffer of the global batch, then summed (exact:
  the other rows add zeros).  ``dL/dx_r`` is rank r's rows of ``dL/dy``, so
  the backward keeps them.  The parameter gradients of rank r then hold the
  contribution of its rows alone, and the step sums them over ``data``.
* ``sum_over_data``: ``y = sum_r x_r`` over the data group, used by every
  rank downstream (BatchNorm's batch sums).  Each rank's ``dL/dy`` holds only
  its own rows' share, so ``dL/dx_r = sum_r' dL/dy|_r'``: an ``all_reduce``
  in the backward too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce_sum",
    "copy_to_model",
    "gather_batch",
    "reduce_from_model",
    "sum_gradients_over_data",
    "sum_over_data",
]


def _reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype == torch.float64:
        return torch.float64
    if dtype.is_floating_point:
        return torch.float32
    return torch.int64


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group``, reduced in fp32 (fp64,
    int64) and cast back to ``x``'s dtype."""
    buf = x.to(_reduce_dtype(x.dtype), copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_sum(dy, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_sum(dy, ctx.group), None


def _scatter_rows(x: torch.Tensor, index: int, count: int) -> torch.Tensor:
    b = x.shape[0]
    buf = torch.zeros((count * b,) + tuple(x.shape[1:]), dtype=_reduce_dtype(x.dtype),
                      device=x.device)
    buf[index * b:(index + 1) * b] = x
    return buf


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, count):
        ctx.rows = (index * x.shape[0], (index + 1) * x.shape[0])
        buf = _scatter_rows(x, index, count)
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        lo, hi = ctx.rows
        return dy[lo:hi], None, None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity forward; the gradient summed over the model group."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the model group; identity backward."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def sum_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the data group, forward and backward."""
    return _SumOverData.apply(x, mesh.data_group)


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch ``[data * b, ...]`` from every data rank's ``[b, ...]``
    rows, in rank order; the backward keeps this rank's rows.  Integer
    tensors (labels) are gathered without a gradient."""
    if not x.is_floating_point():
        buf = _scatter_rows(x, mesh.data_index, mesh.data)
        dist.all_reduce(buf, group=mesh.data_group)
        return buf.to(x.dtype)
    return _GatherBatch.apply(x, mesh.data_group, mesh.data_index, mesh.data)


# entries a gradient bucket holds: 256 MB in fp32
BUCKET = 1 << 26


@torch.no_grad()
def sum_gradients_over_data(params, mesh) -> None:
    """Sum every parameter's ``.grad`` over the data group, in place: the
    gradients are packed into fp32 (fp64 for fp64) buckets of up to
    ``BUCKET`` entries (a larger one goes in pieces), each bucket summed with
    one ``all_reduce``, and the sums written back in each gradient's dtype (a
    bf16 gradient is summed in fp32 and rounded once)."""
    pending, size = [], 0

    def flush():
        buf = torch.cat([t.to(_reduce_dtype(pending[0].dtype)) for t in pending])
        dist.all_reduce(buf, group=mesh.data_group)
        off = 0
        for t in pending:
            t.copy_(buf[off:off + t.numel()])
            off += t.numel()

    for p in params:
        if p.grad is None:
            continue
        if not p.grad.is_contiguous():
            p.grad = p.grad.contiguous()
        for piece in p.grad.view(-1).split(BUCKET):
            if pending and (size + piece.numel() > BUCKET or _reduce_dtype(piece.dtype)
                            != _reduce_dtype(pending[0].dtype)):
                flush()
                pending, size = [], 0
            pending.append(piece)
            size += piece.numel()
    if pending:
        flush()
