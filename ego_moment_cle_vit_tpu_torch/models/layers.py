"""Dense and LayerNorm with the JAX package's parameter and dtype semantics.

Flax ``nn.Dense(dtype=...)`` casts its input and parameters to the compute
dtype; ``nn.LayerNorm`` takes its statistics in fp32 with fp32 scale and
bias.  Dense weights here are stored ``[out, in]`` (torch layout) in whatever
dtype the model chose and cast to the compute dtype at use; LayerNorm
parameters stay fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        pdt = param_dtype or dtype
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=pdt, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_dim, dtype=pdt, device=device)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # casts only where a dtype differs: a no-op .to() still costs a
        # dispatch on the host, which bounds serving at batch 64
        cd = self.compute_dtype
        w, b = self.weight, self.bias
        if w.dtype != cd:
            w = w.to(cd)
        if b is not None and b.dtype != cd:
            b = b.to(cd)
        return F.linear(x if x.dtype == cd else x.to(cd), w, b)


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


class Dropout(nn.Module):
    """Inverted dropout driven by an explicit ``torch.Generator``.

    Active only in training mode with ``p > 0``.  The keep mask is drawn from
    ``generator`` (on the input's device), so a step is reproducible from the
    generator's seed; ``generator=None`` draws from the global stream.
    """

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, dtype=torch.float32, device=x.device,
                          generator=generator) >= self.p
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.p))


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialization close to flax's defaults, from ``generator``.

    Dense and conv kernels: truncated normal with std sqrt(1/fan_in) (flax's
    lecun_normal); biases zero; LayerNorm ones/zeros; Swin relative-position
    tables and the ViT's CLS token and position embedding: truncated normal,
    std 0.02.  GPF coefficients and sketch
    matrices are initialized by their own modules.
    """
    for sub in module.modules():
        if isinstance(sub, Dense):
            _trunc_normal(sub.weight, _LECUN / math.sqrt(sub.weight.shape[1]), generator)
        elif isinstance(sub, nn.Conv2d):
            fan_in = sub.weight[0].numel()
            _trunc_normal(sub.weight, _LECUN / math.sqrt(fan_in), generator)
            nn.init.zeros_(sub.bias)
        for name in ("relative_position_bias_table", "cls_token", "pos_embed"):
            table = getattr(sub, name, None)
            if isinstance(table, nn.Parameter):
                _trunc_normal(table, 0.02, generator)


# flax's lecun_normal divides by the std of a normal truncated at +-2
_LECUN = 1.0 / 0.87962566103423978


@torch.no_grad()
def _trunc_normal(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Normal(0, std) truncated at +-2 std, drawn in fp32, stored in p's dtype."""
    t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    p.copy_(t)
