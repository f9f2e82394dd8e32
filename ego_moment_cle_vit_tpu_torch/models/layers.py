"""Dense, LayerNorm and BatchNorm with the JAX package's parameter and dtype
semantics.

Flax ``nn.Dense(dtype=...)`` casts its input and parameters to the compute
dtype; ``nn.LayerNorm`` takes its statistics in fp32 with fp32 scale and
bias; the heads' ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``
likewise, with fp32 running statistics.  Dense weights here are stored
``[out, in]`` (torch layout) in whatever dtype the model chose and cast to the
compute dtype at use; norm parameters stay fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_model, reduce_from_model, sum_over_data
from ..parallel.shard_kernels import active_kernel_mesh, local_rows


class Dense(nn.Module):
    """``flax_kernel_shape`` / ``flax_in_axes`` describe a flax
    ``DenseGeneral`` kernel (e.g. attention's ``[in, heads, head_dim]``, whose
    first ``flax_in_axes`` axes are the input's) for the weight converter;
    None for a plain ``Dense``.

    Row-parallel form (``shard_fan_in``, switched on by
    ``parallel.shard_params``): the weight keeps this model rank's block of
    the input columns; the forward multiplies the same block of the input and
    sums the partial products over the model group in fp32, then adds the
    (replicated) bias in fp32 and rounds once to the compute dtype.  The
    input's gradient is summed over the model group (each rank holds its
    block's columns of it)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None,
                 device=None, flax_kernel_shape: tuple | None = None, flax_in_axes: int = 1):
        super().__init__()
        pdt = param_dtype or dtype
        self.compute_dtype = dtype
        self.flax_kernel_shape = flax_kernel_shape
        self.flax_in_axes = flax_in_axes
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=pdt, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_dim, dtype=pdt, device=device)) if bias else None
        )
        self.fan_in_shard = None  # (mesh, first column) in the row-parallel form

    @torch.no_grad()
    def shard_fan_in(self, mesh) -> None:
        """Keep this model rank's block of the input columns (the mesh's
        model axis must divide the fan-in)."""
        n = self.weight.shape[1] // mesh.model
        lo = mesh.model_index * n
        self.weight = nn.Parameter(self.weight[:, lo:lo + n].contiguous())
        self.fan_in_shard = (mesh, lo)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # casts only where a dtype differs: a no-op .to() still costs a
        # dispatch on the host, which bounds serving at batch 64
        cd = self.compute_dtype
        w, b = self.weight, self.bias
        if w.dtype != cd:
            w = w.to(cd)
        x = x if x.dtype == cd else x.to(cd)
        if self.fan_in_shard is not None:
            mesh, lo = self.fan_in_shard
            xb = copy_to_model(x, mesh)[..., lo:lo + w.shape[1]]
            y = reduce_from_model(F.linear(xb, w), mesh)
            return y if b is None else (y.float() + b.float()).to(cd)
        if b is not None and b.dtype != cd:
            b = b.to(cd)
        return F.linear(x, w, b)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and parameters; output in ``out_dtype``
    (None: the input's dtype).  fp64 input stays fp64 throughout (a model
    built in fp64 holds its parameters in fp64 too).  ``eps`` has no default
    on purpose: flax defaults to 1e-6 (head norms), Swin passes 1e-5."""

    def __init__(self, dim: int, *, eps: float, out_dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        self.eps = eps
        self.out_dtype = out_dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float64:
            return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)
        out_dtype = self.out_dtype or x.dtype
        # CUDA layer_norm takes no bf16 input with fp32 parameters
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(out_dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    the features of ``[B, F]``.

    Training mode normalizes with the batch's statistics, taken in fp32 with
    the biased variance ``max(E[x^2] - E[x]^2, 0)`` (flax's fast variance),
    and moves the running statistics ``r <- m r + (1 - m) batch`` with that
    same biased variance (``nn.BatchNorm1d`` would use the unbiased one).
    Eval mode normalizes with the running statistics, which are buffers and
    so ride the model's ``state_dict``.  The output is fp32 (fp64 for fp64
    input).

    On a mesh (``parallel.kernel_mesh``) the batch is the global one: each
    rank sums ``x`` and ``x^2`` over its rows, the sums are added over the data
    group (forward and backward), and every rank takes the same statistics
    and moves its running statistics alike."""

    def __init__(self, dim: int, *, momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, dtype=torch.float32,
                                                         device=device))
        self.register_buffer("running_var", torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xw = x if x.dtype == torch.float64 else x.float()
        if self.training:
            mesh = active_kernel_mesh()
            if mesh is None:
                mean = xw.mean(dim=0)
                mean_sq = torch.square(xw).mean(dim=0)
            else:
                sums = sum_over_data(torch.stack([xw.sum(dim=0), torch.square(xw).sum(dim=0)]),
                                     mesh)
                mean, mean_sq = sums / (xw.shape[0] * mesh.data)
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        return (xw - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class Dropout(nn.Module):
    """Inverted dropout driven by an explicit ``torch.Generator``.

    Active only in training mode with ``p > 0``.  The keep mask is drawn from
    ``generator`` (on the input's device), so a step is reproducible from the
    generator's seed; ``generator=None`` draws from the global stream.

    On a mesh (``parallel.kernel_mesh``) each rank draws the mask of the
    global batch and keeps its rows, so the masks are the one-device step's:
    the local rows are ``k`` blocks of the rank's ``b`` samples (k = 2 in the
    dual-view backbone), the global ones ``k`` blocks of ``data x b``.  Every
    rank draws ``data`` times the numbers it uses.
    """

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        mesh = active_kernel_mesh()
        if mesh is None:
            u = torch.rand(x.shape, dtype=torch.float32, device=x.device, generator=generator)
        else:
            k, b = local_rows(x.shape[0])
            rest = tuple(x.shape[1:])
            u = torch.rand((k * mesh.data * b,) + rest, dtype=torch.float32, device=x.device,
                           generator=generator).view((k, mesh.data, b) + rest)
            u = u[:, mesh.data_index].reshape(x.shape)
        keep = u >= self.p
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.p))


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialization close to flax's defaults, from ``generator``.

    Dense and conv kernels: truncated normal with std sqrt(1/fan_in) (flax's
    lecun_normal); biases zero; LayerNorm ones/zeros; Swin relative-position
    tables and the ViT's CLS token, registers and position embedding:
    truncated normal, std 0.02; LayerScale vectors keep their initial value; a
    bilinear classifier kernel ``[hidden, d_cls, d_moment]``:
    lecun_normal over its fan-in ``d_cls``.  GPF coefficients and sketch
    matrices are initialized by their own modules.
    """
    for sub in module.modules():
        if isinstance(sub, Dense):
            _trunc_normal(sub.weight, _LECUN / math.sqrt(sub.weight.shape[1]), generator)
        elif isinstance(sub, nn.Conv2d):
            fan_in = sub.weight[0].numel()
            _trunc_normal(sub.weight, _LECUN / math.sqrt(fan_in), generator)
            nn.init.zeros_(sub.bias)
        for name in ("relative_position_bias_table", "cls_token", "reg_token", "pos_embed"):
            table = getattr(sub, name, None)
            if isinstance(table, nn.Parameter):
                _trunc_normal(table, 0.02, generator)
        bilinear = getattr(sub, "bilinear_kernel", None)
        if isinstance(bilinear, nn.Parameter):  # [hidden, in, in2]: fan-in is axis 1
            _trunc_normal(bilinear, _LECUN / math.sqrt(bilinear.shape[1]), generator)


# flax's lecun_normal divides by the std of a normal truncated at +-2
_LECUN = 1.0 / 0.87962566103423978


@torch.no_grad()
def _trunc_normal(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Normal(0, std) truncated at +-2 std, drawn in fp32, stored in p's dtype."""
    t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    p.copy_(t)
