"""Newton–Schulz iSQRT of the dense moment route: three CUDA kernels and their
plain versions.

The moment head's dense route (N >= D) takes ``M^-1/2`` of M = Zc^T W Zc,
``[B, D, D]``.  The TPU package (``ego_moment_cle_vit_tpu/ops/pallas/
newton_schulz.py``, ``newton_schulz_isqrt_pallas``) picks one of three kernel
variants by width alone (``_dispatch``), and :func:`newton_schulz_isqrt_fwd`
makes the same choice (:func:`variant_for`):

* ``"fp32"``, D <= 825 (``_fp32_fits``): :func:`newton_schulz_isqrt_fp32_fwd`
  replaces ``_ns_kernel``, the coupled iteration in its symmetric
  three-product form, fp32 throughout.  ViT-Base at a 448 input:
  ``[64, 768, 768]``.  Source ``csrc/newton_schulz.cu``.
* ``"bf16"``, 826 <= D <= 1059 (``_bf16_resident_fits``):
  :func:`newton_schulz_isqrt_bf16_fwd` replaces ``_ns_kernel_bf16``, the
  single-matrix iteration on ``Mn = bf16(M / tr)`` with bf16 storage and fp32
  sums, its products on the Hopper GEMM that 5″ runs too (its launches
  :func:`bf16_gemm_geometry`).  ViT-Large at a 512 input:
  ``[64, 1024, 1024]``.  Source ``csrc/newton_schulz_bf16.cu``.
* ``"bf16_streamed"``, D % 512 == 0 past those, up to 1536
  (``_bf16_streamed_fits``): :func:`newton_schulz_isqrt_bf16_streamed_fwd`
  replaces ``_ns_kernel_bf16_streamed``, the same fixed point with its
  products regrouped, on a Hopper GEMM (``csrc/ns_sm90.cuh``: wgmma fed by a
  TMA ring; its tiles :func:`streamed_gemm_geometry`).  Swin-Large at a 1280
  input: ``[64, 1536, 1536]``.  Source ``csrc/newton_schulz_bf16_streamed.cu``.

On the card a width that no variant takes raises (the TPU package runs its
plain XLA iteration there; no registered backbone has such a width).  On the
CPU every width takes the fp32 :func:`newton_schulz_isqrt_plain`, as the JAX
package's CPU path runs the XLA iteration (its kernels are TPU-only).  The
bf16 variants' plain versions (``*_bf16_plain``, ``*_bf16_streamed_plain``)
round where their kernels round; tests and ``chip_smoke.py`` hold the kernels
against them.  The dispatch is by width only: fp32 matrices at D = 1024 take
the bf16 variant too, as on the TPU.

The TPU package has no backward kernel: for every variant its ``custom_vjp``
differentiates the plain fp32 XLA iteration from the saved M.
``NewtonSchulzFunction`` does the same with autograd over
:func:`newton_schulz_isqrt_plain`.
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
_BF16_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BF16_SIGNATURES = {"newton_schulz_isqrt_bf16": (_BF16_ARGTYPES, ctypes.c_int)}
_BF16_STREAMED_SIGNATURES = {"newton_schulz_isqrt_bf16_streamed": (_BF16_ARGTYPES, ctypes.c_int)}
# The bf16 kernels iterate on matrices padded to a multiple of the GEMM's
# column tile (csrc/ns_bf16.cuh, kTile), in a scratch of five such matrices
# (Mn, Y twice, two products).
BF16_SCRATCH_MATRICES = 5
# Both bf16 kernels' products (csrc/ns_sm90.cuh on csrc/gemm_sm90.cuh): a
# block owns a [128][256] tile of C and walks the contraction in stages of
# 64, four in flight, an A tile [128][64] and a B tile [64][256] a stage,
# behind 1024 bytes of alignment slack and a full and an empty barrier a
# stage.
STREAMED_ROWS, STREAMED_COLS, STREAMED_K, STREAMED_STAGES = 128, 256, 64, 4
BF16_TILE = STREAMED_COLS
SMEM_LIMIT = 232448  # what a block may use on an H100

# The TPU kernels' VMEM envelopes, which decide the variant.  The CUDA kernels
# keep their matrices in device memory and have no limit of their own; each
# takes the widths its TPU kernel takes, so both packages pick alike.
_MIB = 1024 * 1024


def fp32_fits(d: int) -> bool:
    """``_fp32_fits``: M, the result and three fp32 work matrices under 13 MiB
    (D <= 825)."""
    return d >= 1 and 5 * d * d * 4 < 13 * _MIB


def bf16_resident_fits(d: int) -> bool:
    """``_bf16_resident_fits``: four resident bf16 matrices and a halved fp32
    product under 15 MiB (D <= 1059)."""
    return d >= 1 and 7 * d * d * 2 < 15 * _MIB


def bf16_streamed_fits(d: int) -> bool:
    """``_bf16_streamed_fits``: Y and P resident, M streamed in D/4 column
    tiles with an fp32 product tile, under 14 MiB, on the TPU's 512 grain
    (D in 512, 1024, 1536)."""
    return d >= 1 and d % 512 == 0 and 2 * d * d * 2 + d * (d // 4) * (2 + 4) < 14 * _MIB


def variant_for(d: int) -> str | None:
    """The variant the TPU package's ``_dispatch`` runs at width D:
    ``"fp32"``, ``"bf16"``, ``"bf16_streamed"``, or None where it runs the
    XLA iteration."""
    if fp32_fits(d):
        return "fp32"
    if bf16_resident_fits(d):
        return "bf16"
    if bf16_streamed_fits(d):
        return "bf16_streamed"
    return None


def streamed_gemm_geometry(d: int) -> dict:
    """How the bf16 kernels' GEMM (``csrc/ns_sm90.cuh``) cuts one D x D
    product: ``row_blocks`` x ``col_blocks`` blocks of ``rows`` x ``cols``,
    each walking ``k_tiles`` stages of ``k``, ``stages`` in flight, ``smem``
    bytes of shared memory (the C side's ``Layout<1>::bytes``).  The tile
    takes no ragged edge: D must be a multiple of 256 (the variant runs at
    D % 512 == 0 only, :func:`bf16_streamed_fits`), else ValueError."""
    if d < STREAMED_COLS or d % STREAMED_COLS:
        raise ValueError(f"the streamed kernel's GEMM takes D a multiple of {STREAMED_COLS}, "
                         f"got {d}")
    stage = STREAMED_ROWS * STREAMED_K * 2 + STREAMED_K * STREAMED_COLS * 2
    return {"rows": STREAMED_ROWS, "row_blocks": d // STREAMED_ROWS, "cols": STREAMED_COLS,
            "col_blocks": d // STREAMED_COLS, "k": STREAMED_K, "k_tiles": d // STREAMED_K,
            "stages": STREAMED_STAGES,
            "smem": 1024 + STREAMED_STAGES * stage + 16 * STREAMED_STAGES}


def bf16_gemm_geometry(d: int) -> dict:
    """Kernel 5′'s launches at width D: it iterates on Dp x Dp matrices, D
    zero-padded to ``dp``, a multiple of the GEMM's 256-column tile (exact:
    the padding stays zero through every product and update), each product
    cut as :func:`streamed_gemm_geometry` cuts a Dp x Dp one, in a scratch of
    ``scratch_bytes`` a matrix of the batch.  Takes the widths the variant
    runs at, 826 <= D <= 1059 (``variant_for(d) == "bf16"``); any other D
    raises ValueError."""
    if variant_for(d) != "bf16":
        raise ValueError(f"kernel 5′ takes 826 <= D <= 1059 (the TPU kernel's "
                         f"_bf16_resident_fits past _fp32_fits), got {d}")
    dp = -(-d // BF16_TILE) * BF16_TILE
    return {"dp": dp, "scratch_bytes": BF16_SCRATCH_MATRICES * dp * dp * 2,
            **streamed_gemm_geometry(dp)}


def unsupported_width(d: int) -> str:
    return (f"no Newton–Schulz kernel takes D={d} (fp32 D <= 825, bf16 826 <= D <= 1059, "
            "bf16 streamed D = 1536); the TPU package runs its XLA iteration there, which the "
            "port does not substitute on the card (ROADMAP.md, 'TPU kernels to port', widths "
            "no variant takes)")


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain version's compute type: fp32, or fp64 when given fp64."""
    return t if t.dtype == torch.float64 else t.float()


def newton_schulz_isqrt_plain(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Plain PyTorch version of the fp32 kernel, in the TPU kernel's order:
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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A B of bf16 matrices, summed in fp32 (products of bf16 values are exact
    in fp32), not yet rounded."""
    return torch.matmul(a.float(), b.float())


def _trace(matrix: torch.Tensor, eps: float) -> torch.Tensor:
    """``trace(M) + eps`` in fp32, [B].  The bf16 kernels' wrapper hands this
    to the kernel and the plain versions divide by it, so a kernel and its
    plain version normalize by the same bits (their divisions, square root and
    roundings are IEEE fp32 on both sides)."""
    return torch.diagonal(matrix, dim1=-2, dim2=-1).float().sum(-1) + eps


def _bf16_plain(matrix: torch.Tensor, num_iterations: int, eps: float, step) -> torch.Tensor:
    """The bf16 variants' frame, as ``_forward_bf16``: in fp32
    ``Mn = bf16(M / tr)``; ``Y = I`` in bf16; ``step(Y, Mn)`` k times;
    ``Y / sqrt(tr)`` in fp32, then M's dtype."""
    trace = _trace(matrix, eps)[..., None, None]
    mn = _bf16(matrix.float() / trace)
    y = torch.eye(mn.shape[-1], dtype=torch.bfloat16, device=mn.device).expand(mn.shape)
    for _ in range(num_iterations):
        y = step(y, mn)
    return (y.float() / torch.sqrt(trace)).to(matrix.dtype)


def _update(y: torch.Tensor, prod: torch.Tensor) -> torch.Tensor:
    """``bf16(1.5 Y - 0.5 prod)``, formed in fp32."""
    return _bf16(1.5 * y.float() - 0.5 * prod)


def bf16_step(y: torch.Tensor, mn: torch.Tensor) -> torch.Tensor:
    """One step of kernel 5′ at its rounding points: ``T1 = bf16(Y Y)``,
    ``T2 = bf16(Mn T1)``, ``Y <- bf16(1.5 Y - 0.5 Y T2)``, every product
    summed in fp32."""
    t1 = _bf16(_product(y, y))
    t2 = _bf16(_product(mn, t1))
    return _update(y, _product(y, t2))


def bf16_streamed_step(y: torch.Tensor, mn: torch.Tensor) -> torch.Tensor:
    """One step of kernel 5″ at its rounding points: ``P = bf16(Y Mn)``,
    ``P <- bf16(P Y)``, ``Y <- bf16(1.5 Y - 0.5 P Y)``, every product summed
    in fp32."""
    p = _bf16(_product(y, mn))
    p = _bf16(_product(p, y))
    return _update(y, _product(p, y))


def newton_schulz_isqrt_bf16_plain(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Plain PyTorch version of kernel 5′ (``_ns_kernel_bf16``), rounding where
    it rounds: k steps of :func:`bf16_step` in the bf16 frame."""
    return _bf16_plain(matrix, num_iterations, eps, bf16_step)


def newton_schulz_isqrt_bf16_streamed_plain(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Plain PyTorch version of kernel 5″ (``_ns_kernel_bf16_streamed``),
    rounding where it rounds: k steps of :func:`bf16_streamed_step` in the
    bf16 frame."""
    return _bf16_plain(matrix, num_iterations, eps, bf16_streamed_step)


def _checked(matrix: torch.Tensor, num_iterations: int, what: str) -> int:
    """Raise on what the kernels do not take; returns the dtype code."""
    if matrix.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {matrix.device}")
    if matrix.dim() != 3 or matrix.shape[-1] != matrix.shape[-2] or matrix.shape[-1] < 1:
        raise ValueError(f"matrix must be [B, D, D], got {tuple(matrix.shape)}")
    if num_iterations < 0:
        raise ValueError(f"num_iterations must be >= 0, got {num_iterations}")
    if not matrix.is_contiguous():
        raise ValueError("matrix must be contiguous")
    return _build.dtype_code(matrix, what)


def newton_schulz_isqrt_fp32_fwd(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Kernel 5: ``M^-1/2`` of each of [B, D, D] symmetric PSD matrices, fp32
    inside, in M's dtype, for D <= 825 (``fp32_fits``).

    CPU tensors take :func:`newton_schulz_isqrt_plain`; CUDA tensors launch
    the kernel (after dtype, shape and contiguity checks) or raise.  Counts
    one launch per call in ``newton_schulz_isqrt_fp32_fwd.launches``, whatever
    it launches inside.
    """
    if matrix.device.type == "cpu":
        return newton_schulz_isqrt_plain(matrix, num_iterations, eps)
    code = _checked(matrix, num_iterations, "newton_schulz_isqrt_fp32_fwd")
    b, d, _ = matrix.shape
    if not fp32_fits(d):
        raise ValueError(f"the fp32 kernel takes D <= 825 (the TPU kernel's _fp32_fits), got {d}")
    out = torch.empty_like(matrix)
    # Y and Z two buffers each, T, the traces
    work = torch.empty(5 * b * d * d + b, dtype=torch.float32, device=matrix.device)
    _build.launch(f"{__name__}:newton_schulz_isqrt_fp32_fwd", "newton_schulz", _SIGNATURES,
                  matrix.device, matrix.data_ptr(), out.data_ptr(), work.data_ptr(), b, d,
                  num_iterations, float(eps), code)
    return out


newton_schulz_isqrt_fp32_fwd.launches = 0


def _bf16_fwd(wrapper: str, source: str, signatures: dict, geometry, matrix: torch.Tensor,
              num_iterations: int, eps: float) -> torch.Tensor:
    """Kernel 5′'s or 5″'s buffers at ``geometry``'s padded width, then its launch."""
    code = _checked(matrix, num_iterations, wrapper)
    b, d, _ = matrix.shape
    dp = geometry(d).get("dp", d)
    trace = _trace(matrix, eps)
    out = torch.empty_like(matrix)
    work = torch.empty(BF16_SCRATCH_MATRICES * b * dp * dp, dtype=torch.bfloat16,
                       device=matrix.device)
    _build.launch(f"{__name__}:{wrapper}", source, signatures, matrix.device, matrix.data_ptr(),
                  out.data_ptr(), work.data_ptr(), trace.data_ptr(), b, d, num_iterations, code)
    return out


def newton_schulz_isqrt_bf16_fwd(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Kernel 5′: ``M^-1/2`` of [B, D, D] symmetric PSD matrices with bf16
    storage and fp32 sums, in M's dtype (M bf16 or fp32, 826 <= D <= 1059,
    the widths the dispatch gives it; :func:`bf16_gemm_geometry`).

    CPU tensors take :func:`newton_schulz_isqrt_bf16_plain` at any D; CUDA
    tensors launch the kernel or raise.  Counts one launch per call in
    ``newton_schulz_isqrt_bf16_fwd.launches``.
    """
    if matrix.device.type == "cpu":
        return newton_schulz_isqrt_bf16_plain(matrix, num_iterations, eps)
    return _bf16_fwd("newton_schulz_isqrt_bf16_fwd", "newton_schulz_bf16", _BF16_SIGNATURES,
                     bf16_gemm_geometry, matrix, num_iterations, eps)


newton_schulz_isqrt_bf16_fwd.launches = 0


def newton_schulz_isqrt_bf16_streamed_fwd(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """Kernel 5″: as :func:`newton_schulz_isqrt_bf16_fwd` with the products
    regrouped, for D a multiple of 256 (the model reaches it at D = 1536).

    CPU tensors take :func:`newton_schulz_isqrt_bf16_streamed_plain` at any
    D; CUDA tensors launch the kernel or raise.  Counts one launch per call in
    ``newton_schulz_isqrt_bf16_streamed_fwd.launches``.
    """
    if matrix.device.type == "cpu":
        return newton_schulz_isqrt_bf16_streamed_plain(matrix, num_iterations, eps)
    return _bf16_fwd("newton_schulz_isqrt_bf16_streamed_fwd", "newton_schulz_bf16_streamed",
                     _BF16_STREAMED_SIGNATURES, streamed_gemm_geometry, matrix, num_iterations,
                     eps)


newton_schulz_isqrt_bf16_streamed_fwd.launches = 0


def newton_schulz_isqrt_fwd(
    matrix: torch.Tensor, num_iterations: int = 5, eps: float = 1e-5
) -> torch.Tensor:
    """``M^-1/2`` of [B, D, D] symmetric PSD matrices, in M's dtype, by the
    variant the TPU package picks at this width (:func:`variant_for`).

    CPU tensors take the fp32 :func:`newton_schulz_isqrt_plain` at every
    width; CUDA tensors go to the variant's wrapper, and a width no variant
    takes raises ``NotImplementedError``.
    """
    if matrix.device.type == "cpu":
        return newton_schulz_isqrt_plain(matrix, num_iterations, eps)
    d = matrix.shape[-1]
    variant = variant_for(d)
    if variant == "fp32":
        return newton_schulz_isqrt_fp32_fwd(matrix, num_iterations, eps)
    if variant == "bf16":
        return newton_schulz_isqrt_bf16_fwd(matrix, num_iterations, eps)
    if variant == "bf16_streamed":
        return newton_schulz_isqrt_bf16_streamed_fwd(matrix, num_iterations, eps)
    raise NotImplementedError(unsupported_width(d))


class NewtonSchulzFunction(torch.autograd.Function):
    """The dispatched kernel's forward; a backward that recomputes through the
    plain fp32 iteration from the saved M, as the TPU package's ``custom_vjp``
    does for every variant."""

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
    """Differentiable ``M^-1/2`` through the kernels, [B, D, D] -> [B, D, D].
    Where no gradient can be asked for, the forward dispatch is called
    directly."""
    if not (torch.is_grad_enabled() and matrix.requires_grad):
        return newton_schulz_isqrt_fwd(matrix, num_iterations, eps)
    return NewtonSchulzFunction.apply(matrix, num_iterations, eps)
