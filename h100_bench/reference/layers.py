"""The reference's building blocks, in float32: the layers that hold the
served leaves (``Dense``, ``Conv``, ``LayerNorm``) and the dtype the program
serves each leaf in (``served_dtypes``), dropout from an explicit generator,
attention, and the float8 rounding of the control.

``precision='fp8'`` is the control: every product that the configuration
runs in bfloat16 (the Dense layers, the patch convolution and the attention
products) takes its operands rounded to float8 e4m3, each tensor with its own
scale.  A backbone family (``families/<family>.py``) built from these layers
gets the weight plan and the control with no code of its own.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def fp32_products():
    """Full float32 matrix products and convolutions (no TF32) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor, back in
    float32.  Differentiable as the identity (straight-through)."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Dense(nn.Module):
    """y = x W^T + b; ``weight [out, in]``.  Served in the model's dtype."""

    served_in_model_dtype = True

    def __init__(self, d_in: int, d_out: int, precision: str, bias: bool = True):
        super().__init__()
        self.precision = precision
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        if self.precision == "fp8":
            return F.linear(fake_fp8(x), fake_fp8(self.weight), self.bias)
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """Non-overlapping patch convolution, NHWC in, ``[B, h, w, C]`` out."""

    served_in_model_dtype = True

    def __init__(self, d_out: int, patch: int, precision: str):
        super().__init__()
        self.precision, self.patch = precision, patch
        self.weight = nn.Parameter(torch.empty(d_out, 3, patch, patch))
        self.bias = nn.Parameter(torch.empty(d_out))

    def forward(self, images):
        x, w = images.permute(0, 3, 1, 2), self.weight
        if self.precision == "fp8":
            x, w = fake_fp8(x), fake_fp8(w)
        return F.conv2d(x, w, self.bias, stride=self.patch).permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


def dropout(x, p: float, training: bool, generator):
    """Inverted dropout; the keep mask from one ``torch.rand`` of x's shape."""
    if not training or p == 0.0:
        return x
    u = torch.rand(x.shape, dtype=torch.float32, device=x.device, generator=generator)
    return x * (u >= p).float() / (1.0 - p)


def dropout_mask(shape, p: float, generator, device):
    u = torch.rand(shape, dtype=torch.float32, device=device, generator=generator)
    return (u >= p).float() / (1.0 - p)


def attention(q, k, v, precision: str, bias=None):
    """softmax(q k^T + bias) v over the last two axes (q already scaled)."""
    if precision == "fp8":
        q, k, v = fake_fp8(q), fake_fp8(k), fake_fp8(v)
    logits = torch.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    if precision == "fp8":
        probs = fake_fp8(probs)
    return torch.matmul(probs, v)


def served_dtypes(model: nn.Module, model_dtype: torch.dtype) -> dict:
    """{state-dict name: the dtype the program serves it in}: Dense and
    convolution leaves in the model's dtype, every other leaf in float32."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            out[full] = model_dtype if getattr(mod, "served_in_model_dtype", False) else torch.float32
    return out
