"""Newton–Schulz iSQRT of the dense moment route: CUDA kernel and plain version.

``newton_schulz_isqrt_fwd`` replaces the TPU kernel ``_ns_kernel`` in
``ego_moment_cle_vit_tpu/ops/pallas/newton_schulz.py`` (reached through
``newton_schulz_isqrt_pallas`` when ``_fp32_fits``): the coupled iteration
for ``M^-1/2`` in its symmetric three-product form, fp32 throughout, trace
normalized in and ``1 / sqrt(trace)`` out, the result in M's dtype.  The
moment head takes it on the dense route (N >= D), where M = Zc^T W Zc is
``[B, D, D]``: ViT-Base at a 448 input gives ``[64, 768, 768]``.

The kernel source and its design note are in ``csrc/newton_schulz.cu``:
nothing stays on chip at these sizes, so each product is one launch of a
batched tiled fp32 GEMM with the update fused into its epilogue.  The TPU
package has two more variants for wider matrices (``_ns_kernel_bf16`` for
825 <= D <= 1056, ``_ns_kernel_bf16_streamed`` for D = 1536); they are not
ported, and a CUDA tensor of such a width raises.

The TPU package has no backward kernel: its ``custom_vjp`` differentiates the
plain XLA iteration from the saved M.  ``NewtonSchulzFunction`` does the same
with autograd over ``newton_schulz_isqrt_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SIGNATURES = {
    "newton_schulz_isqrt": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                      ctypes.c_void_p],
        ctypes.c_int,
    )
}
# The TPU kernel's fp32 envelope (``_fp32_fits``): M, the result and three
# fp32 work matrices under 13 MiB of VMEM, D <= 825.  The CUDA kernel keeps
# its matrices in device memory and has no limit of its own; it takes the
# widths the TPU kernel's fp32 variant takes, and the bf16 variants' widths
# wait for their own port.
_FP32_VMEM_BYTES = 13 * 1024 * 1024


def kernel_supports(d: int) -> bool:
    """Whether the fp32 kernel takes [*, D, D] matrices: ``_fp32_fits``."""
    return d >= 1 and 5 * d * d * 4 < _FP32_VMEM_BYTES


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain version's compute type: fp32, or fp64 when given fp64."""
    return t if t.dtype == torch.float64 else t.float()


def newton_schulz_isqrt_plain(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in the TPU kernel's order:
    ``Z = M / (tr + eps)``, ``Y = I``; each step ``T = Z Y``,
    ``Y <- 1.5 Y - 0.5 Y T``, ``Z <- 1.5 Z - 0.5 T^T Z``; then
    ``Y / sqrt(tr + eps)`` in M's dtype.  fp32 inside (fp64 for fp64 input).
    """
    m = _wide(matrix)
    trace = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)[..., None, None] + eps
    z = m / trace
    y = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device).expand(m.shape)
    for _ in range(num_iterations):
        t = torch.matmul(z, y)
        y_next = 1.5 * y - 0.5 * torch.matmul(y, t)
        z = 1.5 * z - 0.5 * torch.matmul(t.transpose(-1, -2), z)
        y = y_next
    return (y / torch.sqrt(trace)).to(matrix.dtype)


def newton_schulz_isqrt_fwd(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """``M^-1/2`` of each of [B, D, D] symmetric PSD matrices, in M's dtype.

    CPU tensors take :func:`newton_schulz_isqrt_plain`; CUDA tensors launch
    the kernel (after dtype, shape and contiguity checks) or raise.  Counts
    one launch per call in ``newton_schulz_isqrt_fwd.launches``, whatever it
    launches inside.
    """
    if matrix.device.type == "cpu":
        return newton_schulz_isqrt_plain(matrix, num_iterations, eps)
    if matrix.device.type != "cuda":
        raise RuntimeError(f"newton_schulz_isqrt_fwd: unsupported device {matrix.device}")
    if matrix.dim() != 3 or matrix.shape[-1] != matrix.shape[-2]:
        raise ValueError(f"matrix must be [B, D, D], got {tuple(matrix.shape)}")
    b, d, _ = matrix.shape
    if not kernel_supports(d):
        raise ValueError(f"the fp32 kernel takes D <= 825 (the TPU kernel's _fp32_fits), got {d}")
    if num_iterations < 0:
        raise ValueError(f"num_iterations must be >= 0, got {num_iterations}")
    if not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous")
    code = _build.dtype_code(matrix, "newton_schulz_isqrt_fwd")
    out = torch.empty_like(matrix)
    # Y and Z two buffers each, T, the traces
    work = torch.empty(5 * b * d * d + b, dtype=torch.float32, device=matrix.device)
    lib = _build.load("newton_schulz", _SIGNATURES)
    rc = lib.newton_schulz_isqrt(matrix.data_ptr(), out.data_ptr(), work.data_ptr(), b, d,
                                 num_iterations, float(eps), code,
                                 _build.stream_ptr(matrix.device))
    _build.check(lib, rc, "newton_schulz_isqrt_fwd")
    newton_schulz_isqrt_fwd.launches += 1
    return out


newton_schulz_isqrt_fwd.launches = 0


class NewtonSchulzFunction(torch.autograd.Function):
    """The kernel's forward; a backward that recomputes through the plain
    iteration from the saved M, as the TPU package's ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, matrix, num_iterations, eps):
        ctx.save_for_backward(matrix)
        ctx.geometry = (num_iterations, eps)
        return newton_schulz_isqrt_fwd(matrix, num_iterations, eps)

    @staticmethod
    def backward(ctx, grad):
        (matrix,) = ctx.saved_tensors
        num_iterations, eps = ctx.geometry
        with torch.enable_grad():
            m = matrix.detach().requires_grad_()
            y = newton_schulz_isqrt_plain(m, num_iterations, eps)
        (dm,) = torch.autograd.grad(y, m, grad)
        return dm, None, None


def newton_schulz_isqrt_kernel(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Differentiable ``M^-1/2`` through the kernel, [B, D, D] -> [B, D, D].
    Where no gradient can be asked for, the forward wrapper is called
    directly."""
    if not (torch.is_grad_enabled() and matrix.requires_grad):
        return newton_schulz_isqrt_fwd(matrix, num_iterations, eps)
    return NewtonSchulzFunction.apply(matrix, num_iterations, eps)
