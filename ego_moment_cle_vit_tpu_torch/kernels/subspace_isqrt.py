"""The token-subspace iSQRT-COV of the moment head, where no gradient is
wanted, as a Hopper kernel.

``MomentHead._isqrt`` takes ``M2^-1/2`` of ``M2 = A^T B`` (A = centered,
B = weighted, ``[B, N, D]``, N < D) in the N-dim token subspace
(``ops/moments.py:isqrt_cov_subspace``).  Under ``inference_mode`` or
``no_grad`` on the card (serving, the evaluator) it calls
:func:`subspace_isqrt_fwd`, whose kernel is ``csrc/subspace_isqrt.cu``.

The kernel replaces no TPU kernel: the JAX package leaves this iteration to XLA
(``ego_moment_cle_vit_tpu/ops/moments.py:336``, ``isqrt_cov_subspace``).  It
was added because the route, as fp32 products on the CUDA cores, held 30 % of
a ViT-L/16 serving call at 448 (N = 784, D = 1024).  Its bound is operations:
the products are fp32-accurate, each fp32 operand split into three bf16 terms
whose six cross products down to 2^-24 run on bf16 ``wgmma`` (three where one
side is exactly bf16), so the fp32-accurate operations run at a sixth (or a
third) of the bf16 rate (:func:`bound_flops`).

The schedule: iteration 1 leaves H = I and G = -I/2 exactly, and runs no product; in
iteration 2 the products by G = -I/2 are exact scalings (S G = -S/2,
G (S G) = S/4, G (S H) = -(S H)/2), so only S X and S H run; iterations 3..k
run five products each; then G B^ and A^T (G B^).  Every element is what
``isqrt_cov_subspace`` computes: the CPU tests hold a plain copy of the
schedule to it bit for bit, and ``isqrt_cov_subspace`` is the plain version
that CPU tensors take.

The differentiable path stays ``isqrt_cov_subspace`` (autograd over plain
products): the kernel has no backward, and recomputing the plain forward in
the backward, as ``NewtonSchulzFunction`` does for the dense route, would add
that forward's ~44 ms to a ViT-L/448 training step.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.moments import isqrt_cov_subspace
from . import _build

_SIGNATURES = {
    "subspace_isqrt": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                      ctypes.c_void_p],
        ctypes.c_int,
    )
}


def pitch(n: int) -> int:
    """The row pitch of the kernel's N x N planes: N rounded up to a multiple
    of 8 bf16 values, the 16 bytes a TMA row pitch needs."""
    return -(-n // 8) * 8


def scratch_bytes(b: int, n: int, d: int, dtype: torch.dtype) -> int:
    """The kernel's scratch (``csrc/subspace_isqrt.cu:run``): the fp32 traces
    (256-byte aligned), then three bf16 planes (hi, mid, lo) of each of S, G
    twice, two work matrices whose room G B^ ``[N, D]`` takes at the end, B^,
    and A where it is fp32."""
    nn, nd = n * pitch(n), n * d
    planes = 9 * b * nn + max(6 * b * nn, 3 * b * nd) + 3 * b * nd
    if dtype == torch.float32:
        planes += 3 * b * nd
    return -(-4 * b // 256) * 256 + 2 * planes


def products(num_iterations: int) -> int:
    """N x N products the schedule runs: 2 + 5 (k - 2) for k >= 2, else 0."""
    return 5 * num_iterations - 8 if num_iterations >= 2 else 0


def bound_flops(b: int, n: int, d: int, num_iterations: int, exact_inputs: bool) -> int:
    """bf16 tensor-core operations of one call: each fp32-accurate product
    times its cross products, six, or three where A is exactly bf16
    (``exact_inputs``, the bf16 model): S = B^ A^T, the N x N products, G B^
    and A^T (G B^).  Over 989 TFLOP/s, the kernel's bound."""
    if num_iterations == 0:
        return 0
    a_terms = 3 if exact_inputs else 6
    last = 2 * d * d * n * a_terms
    if num_iterations == 1:
        return b * last
    return b * (2 * n * n * d * a_terms + products(num_iterations) * 2 * n ** 3 * 6
                + 2 * n * n * d * 6 + last)


def bound_bytes(b: int, n: int, d: int, element_size: int) -> int:
    """Device-memory bytes of one call: A and B ``[B, N, D]`` read, the
    ``[B, D, D]`` result written, in the inputs' type.  Over 3.35 TB/s, the
    kernel's bound where it moves more than it computes."""
    return (2 * b * n * d + b * d * d) * element_size


def _checked(centered: torch.Tensor, weighted: torch.Tensor, num_iterations: int,
             terms: int) -> int:
    """Raise on what the kernel does not take; returns the dtype code."""
    what = "subspace_isqrt_fwd"
    for x in (centered, weighted):
        if x.device.type != "cuda":
            raise RuntimeError(f"{what}: unsupported device {x.device}")
    if weighted.device != centered.device:
        raise RuntimeError(f"{what}: centered on {centered.device}, weighted on {weighted.device}")
    if weighted.dtype != centered.dtype:
        raise TypeError(f"{what}: centered is {centered.dtype}, weighted {weighted.dtype}")
    if centered.dim() != 3 or weighted.shape != centered.shape:
        raise ValueError(f"{what}: centered and weighted must be one [B, N, D] shape, got "
                         f"{tuple(centered.shape)} and {tuple(weighted.shape)}")
    b, n, d = centered.shape
    if b < 1 or n < 1 or d < 8 or d % 8:
        raise ValueError(f"{what}: takes B, N >= 1 and D a multiple of 8, got {(b, n, d)}")
    if not (centered.is_contiguous() and weighted.is_contiguous()):
        raise ValueError(f"{what}: centered and weighted must be contiguous")
    if num_iterations < 0:
        raise ValueError(f"{what}: num_iterations must be >= 0, got {num_iterations}")
    if terms not in (2, 3):
        raise ValueError(f"{what}: terms must be 3 (or 2, the control), got {terms}")
    return _build.dtype_code(centered, what)


def subspace_isqrt_fwd(
    centered: torch.Tensor, weighted: torch.Tensor, num_iterations: int = 3, eps: float = 1e-5,
    *, _terms: int = 3,
) -> torch.Tensor:
    """``isqrt_cov_subspace(centered, weighted, num_iterations, eps)`` without
    a gradient: ``[B, N, D]`` twice (bf16 or fp32, D a multiple of 8) ->
    ``[B, D, D]`` in their dtype.

    CPU tensors take ``isqrt_cov_subspace``; CUDA tensors launch the kernel
    (after device, dtype, shape and contiguity checks) or raise.  Counts one
    launch per call in ``subspace_isqrt_fwd.launches``, whatever it launches
    inside.  ``_terms`` is a test hook, not an option: 2 drops each fp32
    operand's lo term, the precision control of the card tests and of
    ``chip_smoke.py``.
    """
    if centered.device.type == "cpu":
        return isqrt_cov_subspace(centered, weighted, num_iterations, eps)
    code = _checked(centered, weighted, num_iterations, _terms)
    b, n, d = centered.shape
    out = torch.empty(b, d, d, dtype=centered.dtype, device=centered.device)
    work = torch.empty(scratch_bytes(b, n, d, centered.dtype), dtype=torch.uint8,
                       device=centered.device)
    _build.launch(f"{__name__}:subspace_isqrt_fwd", "subspace_isqrt", _SIGNATURES, centered.device,
                  centered.data_ptr(), weighted.data_ptr(), out.data_ptr(), work.data_ptr(), b, n,
                  d, num_iterations, float(eps), code, _terms)
    return out


subspace_isqrt_fwd.launches = 0
