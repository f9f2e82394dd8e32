"""Separable image resize with the weights of ``jax.image.resize``.

``jax.image.resize(x, shape, "bilinear" | "cubic")`` scales each resized axis
by one weight matrix: a triangle (or Keys cubic) kernel at the output's
sample points, widened by ``1 / scale`` when it shrinks (antialiasing), each
column normalized to sum to one, and zeroed where the sample falls outside
the input.  ``F.interpolate(..., antialias=True)`` treats the border
otherwise, so the port builds the same matrices and applies them as one small
product per axis.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str = "bilinear",
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """The ``[in_size, out_size]`` fp32 matrix ``jax.image.resize`` applies
    along one axis (``antialias=True``, no translation)."""
    if method not in _KERNELS:
        raise ValueError(f"unsupported resize method {method!r}; one of {sorted(_KERNELS)}")
    # 1 / scale is taken in double, then rounded to fp32, as jax does with
    # its Python-float scale
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = _KERNELS[method](x / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for float ``x``: every axis
    whose size changes is resampled by its weight matrix, in fp32 or the
    input's wider float type."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match the input's rank {x.ndim}")
    out = x
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = resize_weights(n_in, n_out, method, x.device).to(out.dtype)
        out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1, axis)
    return out
