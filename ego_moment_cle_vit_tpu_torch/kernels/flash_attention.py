"""q-tiled multi-head self-attention for long sequences: CUDA kernels and
plain versions.

``flash_attention_tiled_fwd`` replaces the TPU kernel ``_fwd_kernel`` in
``ego_moment_cle_vit_tpu/ops/pallas/flash_attention.py`` (reached through
``flash_attention_tiled``), ``flash_attention_tiled_bwd`` its ``_bwd_kernel``.
The layout is the qkv projection's own, ``qkv [B, N, 3C]`` (head ``h`` in
columns ``h*d:(h+1)*d`` of each third), one head split per image, no bias, no
mask but the padding of the key axis.  The ViT backbone calls it where a
sequence is past the packed-attention kernel: a 448 input gives 785 tokens.

The kernel sources and their design notes are in
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``: a forward
block owns 128 query rows and walks the keys in tiles of 64, so nothing of
size ``T x T`` is ever held.  The forward also writes each row's log-sum-exp;
``FlashAttentionTiledFunction`` saves ``(qkv, out, lse)`` (``out`` is kept
alive by the ``proj`` product anyway), so the backward rebuilds the
probabilities exactly, takes ``delta = rowsum(dout * out)`` and needs no
statistics pass.  The layout is the packed attention's with one group per
image, so bf16 runs the same Hopper kernels in both directions
(``csrc/attention_fwd_sm90.cuh``, ``csrc/attention_bwd_sm90.cuh``) with the
launch geometry of ``packed_attention.fwd_geometry`` and ``bwd_geometry``.
Every sum stays inside one block, so outputs and gradients are the same from
run to run.
``flash_attention_tiled`` is the differentiable entry point the model calls,
with the JAX function's signature.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.trace import span
from . import _build
from .packed_attention import bwd_geometry, check_saved, fwd_geometry, geometry_args

_SIGNATURES = {
    "flash_attention_fwd": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "flash_attention_fwd_occupancy": ([ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "flash_attention_bwd_occupancy": ([ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}
HEAD_DIMS = (32, 64)  # the kernels' compiled head widths
ROWS = 128  # query rows an fp32 forward block owns
TILE = 64  # tokens per tile of the axis an fp32 forward block walks; keys are padded to it


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' compute type: fp32, or fp64 when given fp64."""
    return t if t.dtype == torch.float64 else t.float()


def _heads(x: torch.Tensor, parts: int, num_heads: int):
    """[B, N, parts*C] -> ``parts`` tensors [B, H, N, d] in the compute type."""
    b, n, pc = x.shape
    d = pc // parts // num_heads
    x = _wide(x).reshape(b, n, parts, num_heads, d).permute(2, 0, 3, 1, 4)
    return tuple(x[i] for i in range(parts))


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, d] -> [B, N, H*d]."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


def flash_attention_tiled_plain(
    qkv: torch.Tensor, num_heads: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, fp32 inside (fp64 for fp64
    input): ``softmax(q k^T / sqrt(d))`` rounded to qkv's dtype, times v.

    qkv [B, N, 3C] -> (out [B, N, C] in qkv's dtype, lse [B, H, N] in the
    compute type, each row's log-sum-exp of its logits).
    """
    q, k, v = _heads(qkv, 3, num_heads)
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = _merge(torch.matmul(_wide(probs.to(qkv.dtype)), v)).to(qkv.dtype)
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_tiled_bwd_plain(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, the TPU kernel's formulas.

    qkv [B, N, 3C], dout [B, N, C] -> dqkv like qkv.  The probabilities are
    recomputed from qkv; P is rounded to qkv's dtype before ``P^T dout`` and
    ds before the dq / dk products; everything else is fp32 (fp64 for fp64
    input).
    """
    dt = qkv.dtype
    q, k, v = _heads(qkv, 3, num_heads)
    (do,) = _heads(dout, 1, num_heads)
    scale = q.shape[-1] ** -0.5
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(_wide(probs.to(dt)).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
    ds_c = _wide(ds.to(dt))
    dq = torch.matmul(ds_c, k) * scale
    dk = torch.matmul(ds_c.transpose(-1, -2), q) * scale
    return torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1).to(dt)


def kernel_supports(tokens: int, channels: int, num_heads: int) -> bool:
    """Whether the CUDA kernels take ``tokens`` at this width.  Nothing of
    size T is held on chip, so the token count has no limit of its own."""
    return (num_heads > 0 and channels % num_heads == 0
            and channels // num_heads in HEAD_DIMS and tokens >= 1)


def _check(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"qkv must be [B, N, 3C], got {tuple(qkv.shape)}")
    _, t, c3 = qkv.shape
    if not kernel_supports(t, c3 // 3, num_heads):
        raise ValueError(f"the kernel needs C / heads in {HEAD_DIMS}, got C={c3 // 3}, "
                         f"heads={num_heads}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on a 16-byte boundary (the kernel loads 16-byte rows)")


def flash_attention_tiled_fwd(
    qkv: torch.Tensor, num_heads: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """MHSA over whole sequences, qkv [B, N, 3C] -> (out [B, N, C], lse
    [B, H, N] fp32).

    CPU tensors take :func:`flash_attention_tiled_plain`; CUDA tensors launch
    the kernel (after dtype, shape, contiguity and alignment checks) or raise.
    Counts its launches in ``flash_attention_tiled_fwd.launches``.
    """
    if qkv.device.type == "cpu":
        return flash_attention_tiled_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"flash_attention_tiled_fwd: unsupported device {qkv.device}")
    _check(qkv, num_heads)
    code = _build.dtype_code(qkv, "flash_attention_tiled_fwd")
    b, t, c3 = qkv.shape
    c = c3 // 3
    scale = (c // num_heads) ** -0.5
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, t), dtype=torch.float32, device=qkv.device)
    lib = _build.load("flash_attention_fwd", _SIGNATURES)
    with span("kernel.flash_attention_tiled_fwd"):
        rc = lib.flash_attention_fwd(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, c,
                                     num_heads, float(scale),
                                     *geometry_args(fwd_geometry(t, c // num_heads)), code,
                                     _build.stream_ptr(qkv.device))
    _build.check(lib, rc, "flash_attention_tiled_fwd")
    flash_attention_tiled_fwd.launches += 1
    return out, lse


flash_attention_tiled_fwd.launches = 0


def flash_attention_tiled_bwd(
    qkv: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """VJP of :func:`flash_attention_tiled_fwd` to qkv, given the forward's
    ``out`` and ``lse``: dqkv [B, N, 3C].

    CPU tensors take :func:`flash_attention_tiled_bwd_plain`, which recomputes
    from qkv as the TPU kernel does; CUDA tensors launch the kernels (after
    the forward's checks, and on ``out``, ``lse`` and ``dout``) or raise.
    Counts its launches in ``flash_attention_tiled_bwd.launches``.
    """
    if qkv.device.type == "cpu":
        return flash_attention_tiled_bwd_plain(qkv, dout, num_heads)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"flash_attention_tiled_bwd: unsupported device {qkv.device}")
    _check(qkv, num_heads)
    b, t, c3 = qkv.shape
    c = c3 // 3
    check_saved("out", out, qkv, (b, t, c), qkv.dtype)
    check_saved("dout", dout, qkv, (b, t, c), qkv.dtype)
    check_saved("lse", lse, qkv, (b, num_heads, t), torch.float32)
    code = _build.dtype_code(qkv, "flash_attention_tiled_bwd")
    scale = (c // num_heads) ** -0.5
    geo = bwd_geometry(t, c // num_heads)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, num_heads, t), dtype=torch.float32, device=qkv.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    with span("kernel.flash_attention_tiled_bwd"):
        rc = lib.flash_attention_bwd(
            qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
            delta.data_ptr(), b, t, c, num_heads, float(scale), *geometry_args(geo), code,
            _build.stream_ptr(qkv.device))
    _build.check(lib, rc, "flash_attention_tiled_bwd")
    flash_attention_tiled_bwd.launches += 1
    return dqkv


flash_attention_tiled_bwd.launches = 0


def bwd_occupancy(head_dim: int = 64, tokens: int = 785) -> dict:
    """Registers a thread and blocks an SM of the bf16 backward kernels at d =
    64, with the shared memory ``bwd_geometry`` gives at ``tokens``: for
    reports (``chip_smoke.py``).  Needs the card."""
    smem = bwd_geometry(tokens, head_dim)["smem"]
    out = (ctypes.c_int * 4)()
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    _build.check(lib, lib.flash_attention_bwd_occupancy(smem, out), "bwd_occupancy")
    return {"dq_registers": out[0], "dq_blocks_per_sm": out[1], "dkv_registers": out[2],
            "dkv_blocks_per_sm": out[3], "smem": smem}


def fwd_occupancy(head_dim: int = 64, tokens: int = 785) -> dict:
    """Registers a thread and blocks an SM of the bf16 forward kernel at d =
    64, with the shared memory ``fwd_geometry`` gives at ``tokens``: for
    reports (``chip_smoke.py``).  Needs the card."""
    smem = fwd_geometry(tokens, head_dim)["smem"]
    out = (ctypes.c_int * 2)()
    lib = _build.load("flash_attention_fwd", _SIGNATURES)
    _build.check(lib, lib.flash_attention_fwd_occupancy(smem, out), "fwd_occupancy")
    return {"registers": out[0], "blocks_per_sm": out[1], "smem": smem}


class FlashAttentionTiledFunction(torch.autograd.Function):
    """q-tiled MHSA under autograd: forward and backward each go through their
    wrapper (kernel on CUDA tensors, plain version on CPU tensors).  Saves
    ``(qkv, out, lse)``; the probabilities are rebuilt from them."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        out, lse = flash_attention_tiled_fwd(qkv, num_heads)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return flash_attention_tiled_bwd(qkv, out, lse, dout.contiguous(), ctx.num_heads), None


def flash_attention_tiled(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Differentiable bias-free MHSA from a fused qkv projection, qkv
    [B, N, 3C] -> [B, N, C] in qkv's dtype.  Where no gradient can be asked
    for, the forward wrapper is called directly."""
    if not (torch.is_grad_enabled() and qkv.requires_grad):
        return flash_attention_tiled_fwd(qkv, num_heads)[0]
    return FlashAttentionTiledFunction.apply(qkv, num_heads)
