"""EVA-02's SwiGLU glue between fc1 and fc2, where no gradient is wanted, as
one CUDA kernel.

``models/eva.py``'s SwiGLU computes ``fc2(norm(silu(fc1_g(x)) * fc1_x(x)))``
with a LayerNorm over the hidden width W; on the card its products run at W
padded to a multiple of 8 (2730 -> 2736).  Between fc1 and fc2 it needs
``F.pad(LayerNorm(silu(g) * u)[..., :W], (0, P - W))`` of the two fc1
outputs ``[..., P]``: :func:`swiglu_norm_plain`.  Under ``inference_mode`` or
``no_grad`` on the card (serving, the evaluator) the SwiGLU calls
:func:`swiglu_norm_fwd`, whose kernel is ``csrc/swiglu_norm.cu``: one bf16
pass that reads g and u once and writes the normed hidden with its padded
columns exactly 0, SiLU and the product rounded to bf16 where the plain
route rounds them, the statistics and the affine in fp32.

The kernel replaces no TPU kernel: the JAX package has no EVA.  It was added
because the composition (SiLU, the product, the port LayerNorm's fp32 round
trip over a strided slice, PyTorch's non-vectorised LayerNorm at W = 2730,
the pad) took ~2.9 ms of every EVA-02-L block at ``[64 x 1025, 2736]`` on an
H100.  Its bound is bytes: g and u read, the output written
(:func:`bound_bytes`, 0.321 ms at 3.35 TB/s there).

The differentiable path stays :func:`swiglu_norm_plain` under autograd: the
kernel has no backward, and no cell trains EVA.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# the widest padded row the kernel takes: a warp holds a row in registers,
# twelve 16-byte chunks a lane (csrc/swiglu_norm.cu, kMaxChunks)
MAX_WIDTH = 32 * 8 * 12

_SIGNATURES = {
    "swiglu_norm": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
                    ctypes.c_int),
}


def bound_bytes(rows: int, padded: int) -> int:
    """Device-memory bytes of one launch: g and u read, the output written,
    ``[rows, padded]`` bf16 each (w and b, a few KB, left out)."""
    return 3 * rows * padded * 2


def swiglu_norm_plain(g: torch.Tensor, u: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, width: int, eps: float) -> torch.Tensor:
    """``F.pad(LayerNorm(silu(g) * u)[..., :width], (0, P - width))`` for g
    and u ``[..., P]``, the LayerNorm the port's (``models/layers.py``): fp32
    statistics and parameters, the result in g's dtype; float64 throughout
    for float64 g.  Differentiable."""
    h = (F.silu(g) * u)[..., :width]
    if h.dtype == torch.float64:
        y = F.layer_norm(h, (width,), weight, bias, eps)
    else:
        y = F.layer_norm(h.float(), (width,), weight, bias, eps).to(h.dtype)
    pad = g.shape[-1] - width
    return F.pad(y, (0, pad)) if pad else y


def _checked(g: torch.Tensor, u: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             width: int) -> int:
    """Raise on what the kernel does not take; returns the rows."""
    what = "swiglu_norm_fwd"
    if g.dtype != torch.bfloat16 or u.dtype != torch.bfloat16:
        raise TypeError(f"{what}: g and u must be bfloat16, got {g.dtype} and {u.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{what}: weight and bias must be float32, got {weight.dtype} and "
                        f"{bias.dtype}")
    if g.dim() < 1 or u.shape != g.shape:
        raise ValueError(f"{what}: g and u must be one [..., P] shape, got {tuple(g.shape)} "
                         f"and {tuple(u.shape)}")
    padded = g.shape[-1]
    if not (1 <= width <= padded and padded % 8 == 0 and padded <= MAX_WIDTH):
        raise ValueError(f"{what}: takes a width W <= P with P a multiple of 8 up to "
                         f"{MAX_WIDTH}, got W {width}, P {padded}")
    if weight.shape != (width,) or bias.shape != (width,):
        raise ValueError(f"{what}: weight and bias must be [{width}], got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    rows = g.numel() // padded
    if rows < 1:
        raise ValueError(f"{what}: no rows in {tuple(g.shape)}")
    for name, t in (("g", g), ("u", u), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if g.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError(f"{what}: g and u must start on a 16-byte boundary")
    for name, t in (("g", g), ("u", u), ("weight", weight), ("bias", bias)):
        if t.device.type != "cuda" or t.device != g.device:
            raise RuntimeError(f"{what}: {name} on {t.device}; all four must be on one CUDA "
                               "device")
    return rows


def swiglu_norm_fwd(g: torch.Tensor, u: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    width: int, eps: float) -> torch.Tensor:
    """:func:`swiglu_norm_plain` without a gradient: g and u ``[..., P]``
    bf16 (P a multiple of 8, at most ``MAX_WIDTH``), weight and bias
    ``[width]`` fp32 -> ``[..., P]`` bf16, columns ``width..P-1`` exactly 0.

    CPU tensors take :func:`swiglu_norm_plain` (any dtype); CUDA tensors
    launch the kernel (after dtype, shape, width, contiguity and device
    checks) or raise.  Counts each launch in ``swiglu_norm_fwd.launches``.
    """
    if g.device.type == "cpu":
        return swiglu_norm_plain(g, u, weight, bias, width, eps)
    rows = _checked(g, u, weight, bias, width)
    out = torch.empty_like(g)
    _build.launch(f"{__name__}:swiglu_norm_fwd", "swiglu_norm", _SIGNATURES, g.device, g.data_ptr(),
                  u.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, width,
                  g.shape[-1], float(eps))
    return out


swiglu_norm_fwd.launches = 0
