"""Packed-layout multi-head self-attention: CUDA kernels and plain versions.

``packed_attention_fwd`` replaces the TPU kernel ``_fwd_kernel`` in
``ego_moment_cle_vit_tpu/ops/pallas/window_attention.py`` (reached through
``flash_window_attention``), ``packed_attention_bwd`` its ``_bwd_kernel``.
The layout is the qkv projection's own: ``qkv [B, W, T, 3C]`` (``W`` token
groups per image, ``T`` tokens per group, head ``h`` in columns
``h*d:(h+1)*d`` of each third), an optional ``bias [H or 1, T, T]`` and an
optional ``mask [W or 1, T, T]``, both fp32 and additive; ``None`` stands for
zeros.  The ViT backbone calls it with one group per image, ``T = 1 + N``
tokens, no bias and no mask.

The kernel sources and their design notes are in
``csrc/packed_attention_fwd.cu`` and ``csrc/packed_attention_bwd.cu``.  In
bf16 both directions run Hopper kernels shared with the q-tiled attention:
the forward ``csrc/attention_fwd_sm90.cuh`` (blocks of 128 query rows walking
the keys with an online softmax, ``wgmma`` products, a TMA ring of key tiles;
asked for it, it also writes each row's log-sum-exp), the backward
``csrc/attention_bwd_sm90.cuh``; :func:`fwd_geometry` and
:func:`bwd_geometry` compute their launch geometry.  fp32 runs the CUDA-core
kernels of ``csrc/attention_fwd_fp32.cuh`` and ``attention_bwd_fp32.cuh``.
``packed_attention`` is the differentiable entry point the model calls, a
``torch.autograd.Function`` that saves ``(qkv, bias, mask, out, lse)``
(``out`` is kept alive by the ``proj`` product anyway), so the backward
rebuilds the probabilities exactly and takes ``delta = rowsum(dout * out)``
without a statistics pass.  Every sum stays inside one block or goes through
ordered partials, so outputs and gradients are the same from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.trace import span
from . import _build

_SIGNATURES = {
    "packed_attention_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p],
        ctypes.c_int,
    )
}
_BWD_SIGNATURES = {
    "packed_attention_bwd": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 6
        + [ctypes.c_void_p],
        ctypes.c_int,
    )
}
HEAD_DIMS = (32, 64)  # the kernels' compiled head widths
MAX_TOKENS = 256  # tokens per group the wrappers admit; longer sequences are another kernel's
ROWS = 128  # query rows an fp32 forward block owns (and a bias-gradient block)
TILE = 64  # tokens per tile of the axis an fp32 forward block walks; keys are padded to it
# the bias-gradient kernel aims at this many blocks per launch: each block
# walks a chunk of (image, group) pairs for one (128 queries, 64 keys, head)
_DBIAS_TARGET_BLOCKS = 1024
# the bf16 forward (csrc/attention_fwd_sm90.cuh): query rows a block owns (two
# consumer warpgroups of 64), keys per walked tile, the key tiles a block keeps
# in flight at most
FWD_ROWS = 128
FWD_WALK = 64
FWD_MAX_STAGES = 4
# the bf16 backward (csrc/attention_bwd_sm90.cuh): rows a block owns (one
# warpgroup's wgmma M), tokens per walked tile, the walked tiles a block keeps
# in flight at most, and the shared memory a block may use on an H100
BWD_ROWS = 64
BWD_WALK = 64
BWD_MAX_STAGES = 3
SMEM_LIMIT = 232448


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' compute type: fp32, or fp64 when given fp64."""
    return t if t.dtype == torch.float64 else t.float()


def _heads(x: torch.Tensor, parts: int, num_heads: int):
    """[B, W, T, parts*C] -> ``parts`` tensors [B, W, H, T, d]."""
    b, w, t, pc = x.shape
    d = pc // parts // num_heads
    x = _wide(x).reshape(b, w, t, parts, num_heads, d).permute(3, 0, 1, 4, 2, 5)
    return tuple(x[i] for i in range(parts))


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, W, H, T, d] -> [B, W, T, H*d]."""
    b, w, h, t, d = x.shape
    return x.permute(0, 1, 3, 2, 4).reshape(b, w, t, h * d)


def _logits(q, k, bias, mask, scale):
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + _wide(bias)[None, None]  # [Hb, T, T] broadcasts over heads
    if mask is not None:
        logits = logits + _wide(mask)[None, :, None]  # [Wm, T, T] broadcasts over groups
    return logits


def packed_attention_plain(
    qkv: torch.Tensor,
    bias: torch.Tensor | None,
    mask: torch.Tensor | None,
    num_heads: int,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Plain PyTorch version of the forward kernel, fp32 inside (fp64 for
    fp64 input): ``softmax(q k^T * scale + bias + mask)`` rounded to qkv's
    dtype, times v.  qkv [B, W, T, 3C] -> out [B, W, T, C] in qkv's dtype, or
    with ``return_lse`` (out, lse [B*W, H, T] in the compute type: each row's
    log-sum-exp of its logits)."""
    q, k, v = _heads(qkv, 3, num_heads)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = _logits(q, k, bias, mask, scale)
    probs = torch.softmax(logits, dim=-1)
    out = _merge(torch.matmul(_wide(probs.to(qkv.dtype)), v)).to(qkv.dtype)
    if not return_lse:
        return out
    b, w, t, _ = qkv.shape
    return out, torch.logsumexp(logits, dim=-1).reshape(b * w, num_heads, t)


def packed_attention_bwd_plain(
    qkv: torch.Tensor,
    bias: torch.Tensor | None,
    mask: torch.Tensor | None,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the backward kernel, the same formulas.

    qkv [B, W, T, 3C], the forward's out [B, W, T, C] and lse [B*W, H, T],
    dout [B, W, T, C] -> (dqkv like qkv, dbias like bias in fp32, or None
    without a bias).  P = exp(logits - lse) is rebuilt from the logits and
    delta = rowsum(dout * out); P is rounded to qkv's dtype before ``P^T do``
    and ds before the dq / dk products, as in the kernel; everything else is
    fp32 (fp64 for fp64 input).
    """
    dt = qkv.dtype
    q, k, v = _heads(qkv, 3, num_heads)
    (do,) = _heads(dout, 1, num_heads)
    (o,) = _heads(out, 1, num_heads)
    b, w, t, _ = qkv.shape
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    lse = _wide(lse).reshape(b, w, num_heads, t, 1)
    probs = torch.exp(_logits(q, k, bias, mask, scale) - lse)
    dv = torch.matmul(_wide(probs.to(dt)).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = probs * (dp - torch.sum(do * o, dim=-1, keepdim=True))
    dbias = None
    if bias is not None:
        dbias = ds.sum(dim=(0, 1))  # [H, T, T]
        if bias.shape[0] == 1:
            dbias = dbias.sum(dim=0, keepdim=True)
        dbias = dbias.to(bias.dtype)
    ds_c = _wide(ds.to(dt))
    dq = torch.matmul(ds_c, k) * scale
    dk = torch.matmul(ds_c.transpose(-1, -2), q) * scale
    dqkv = torch.cat([_merge(t) for t in (dq, dk, dv)], dim=-1).to(dt)
    return dqkv, dbias


def kernel_supports(tokens: int, channels: int, num_heads: int) -> bool:
    """Whether the CUDA kernels take ``tokens`` per group at this width."""
    return (num_heads > 0 and channels % num_heads == 0
            and channels // num_heads in HEAD_DIMS and 1 <= tokens <= MAX_TOKENS)


def _check(qkv, bias, mask, num_heads):
    if qkv.dim() != 4 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"qkv must be [B, W, T, 3C], got {tuple(qkv.shape)}")
    b, w, t, c3 = qkv.shape
    c = c3 // 3
    if not kernel_supports(t, c, num_heads):
        raise ValueError(
            f"the kernel needs C / heads in {HEAD_DIMS} and T <= {MAX_TOKENS}, got C={c}, "
            f"heads={num_heads}, T={t}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on a 16-byte boundary (the kernel loads 16-byte rows)")
    for name, x, lead in (("bias", bias, (num_heads, 1)), ("mask", mask, (w, 1))):
        if x is None:
            continue
        if x.device != qkv.device:
            raise ValueError(f"{name} is on {x.device}, qkv on {qkv.device}")
        if (x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] not in lead
                or tuple(x.shape[1:]) != (t, t)):
            raise ValueError(f"{name} must be float32 [{lead[0]} or 1, {t}, {t}], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")


def _ptr(x: torch.Tensor | None):
    return x.data_ptr() if x is not None else None


def packed_attention_fwd(
    qkv: torch.Tensor,
    bias: torch.Tensor | None,
    mask: torch.Tensor | None,
    num_heads: int,
    scale: float | None = None,
    return_lse: bool = False,
):
    """MHSA over packed token groups, qkv [B, W, T, 3C] -> out [B, W, T, C],
    or with ``return_lse`` (out, lse [B*W, H, T] fp32), which the backward
    takes.

    CPU tensors take :func:`packed_attention_plain`; CUDA tensors launch the
    kernel (after dtype, shape and contiguity checks) or raise.  Counts its
    launches in ``packed_attention_fwd.launches``.
    """
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, bias, mask, num_heads, scale, return_lse)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"packed_attention_fwd: unsupported device {qkv.device}")
    _check(qkv, bias, mask, num_heads)
    code = _build.dtype_code(qkv, "packed_attention_fwd")
    b, w, t, c3 = qkv.shape
    c = c3 // 3
    scale = (c // num_heads) ** -0.5 if scale is None else scale
    out = torch.empty((b, w, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b * w, num_heads, t), dtype=torch.float32, device=qkv.device)
           if return_lse else None)
    lib = _build.load("packed_attention_fwd", _SIGNATURES)
    with span("kernel.packed_attention_fwd"):
        rc = lib.packed_attention_fwd(
            qkv.data_ptr(), _ptr(bias), _ptr(mask), out.data_ptr(), _ptr(lse), b, w, t, c,
            num_heads, bias.shape[0] if bias is not None else 1,
            mask.shape[0] if mask is not None else 1, float(scale),
            *geometry_args(fwd_geometry(t, c // num_heads)), code, _build.stream_ptr(qkv.device),
        )
    _build.check(lib, rc, "packed_attention_fwd")
    packed_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


packed_attention_fwd.launches = 0


def _dbias_chunks(pairs: int, blocks_per_pair: int) -> int:
    """How many chunks of (image, group) pairs the bias-gradient grid gets:
    enough blocks to fill the card, few enough that the partials stay small.
    Every chunk is non-empty."""
    want = max(1, -(-_DBIAS_TARGET_BLOCKS // blocks_per_pair))
    per_chunk = -(-pairs // min(pairs, want))
    return -(-pairs // per_chunk)


def fwd_geometry(tokens: int, head_dim: int) -> dict:
    """How the bf16 forward kernel (``csrc/attention_fwd_sm90.cuh``, both the
    packed and the q-tiled attention's) cuts one (group, head) of ``tokens``
    tokens.

    A block owns ``rows`` = 128 query rows (two consumer warpgroups of 64; one
    whose rows all lie past the tokens does nothing), so the grid is groups x
    heads x ``row_blocks``.  The keys come in ``walk_tiles`` tiles of 64, the
    last read to ``last``, the next multiple of 16 past the keys left
    (wgmma's N and k-step), with ``stages`` tiles in flight: every tile at once
    up to 256 tokens.  ``smem`` is the shared memory a block asks for, the C
    side's ``Layout::bytes``: alignment slack, a q tile per warpgroup, a k and
    a v tile a stage, the barriers and a release count a stage.
    """
    walk = -(-tokens // FWD_WALK)
    rest = tokens - (walk - 1) * FWD_WALK
    stages = min(FWD_MAX_STAGES, walk)
    tile = FWD_WALK * head_dim * 2  # one [64, d] bf16 tile
    smem = 1024 + tile * (2 + 2 * stages) + 8 * (1 + stages) + 4 * stages
    return {"row_blocks": -(-tokens // FWD_ROWS), "rows": FWD_ROWS, "walk_tiles": walk,
            "tile": FWD_WALK, "last": -(-rest // 16) * 16, "stages": stages, "smem": smem}


def bwd_geometry(tokens: int, head_dim: int) -> dict:
    """How the bf16 backward kernels (``csrc/attention_bwd_sm90.cuh``, both
    the packed and the q-tiled attention's) cut one (group, head) of
    ``tokens`` tokens.

    The dq kernel owns query rows and walks the keys; the dk/dv kernel owns
    keys and walks the queries.  Each has ``row_blocks`` blocks of 64 rows
    (one consumer warpgroup) per (group, head): the grid is groups x heads x
    ``row_blocks``.  The walked axis comes in ``walk_tiles`` tiles of 64, the
    last read to ``last``, the next multiple of 16 past the tokens left
    (wgmma's N and k-step), with ``stages`` tiles in flight.  ``smem`` is the
    shared memory a block asks for, the C side's ``Layout::bytes``: alignment
    slack, the two owned tiles, two walked tiles and their statistics a stage,
    the barriers.
    """
    walk = -(-tokens // BWD_WALK)
    rest = tokens - (walk - 1) * BWD_WALK
    stages = min(BWD_MAX_STAGES, max(2, walk))
    tile = BWD_WALK * head_dim * 2  # one [64, d] bf16 tile
    smem = 1024 + tile * (2 + 2 * stages) + 2 * BWD_WALK * 4 * stages + 8 * (1 + 2 * stages)
    return {"row_blocks": -(-tokens // BWD_ROWS), "rows": BWD_ROWS, "walk_tiles": walk,
            "tile": BWD_WALK, "last": -(-rest // 16) * 16, "stages": stages, "smem": smem}


def geometry_args(geo: dict) -> tuple:
    """The geometry as the C entry points take it."""
    return geo["row_blocks"], geo["last"], geo["stages"], geo["smem"]


def check_saved(name: str, x: torch.Tensor, like: torch.Tensor, shape: tuple, dtype) -> None:
    """A backward input must be contiguous, 16-byte aligned and of this shape
    and dtype, on ``like``'s device."""
    if (x.device != like.device or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} on {like.device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def packed_attention_bwd(
    qkv: torch.Tensor,
    bias: torch.Tensor | None,
    mask: torch.Tensor | None,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    scale: float | None = None,
    need_dbias: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """VJP of :func:`packed_attention_fwd`, given its ``out`` and ``lse``:
    (dqkv, dbias); the mask gets none.

    ``dbias`` is None without a bias or with ``need_dbias=False`` (then the
    kernel skips that work).  CPU tensors take
    :func:`packed_attention_bwd_plain`; CUDA tensors launch the kernels (after
    the forward's checks, and on ``out``, ``lse`` and ``dout``) or raise.
    Counts its launches in ``packed_attention_bwd.launches``.
    """
    if qkv.device.type == "cpu":
        dqkv, dbias = packed_attention_bwd_plain(qkv, bias, mask, out, lse, dout, num_heads, scale)
        return dqkv, dbias if need_dbias else None
    if qkv.device.type != "cuda":
        raise RuntimeError(f"packed_attention_bwd: unsupported device {qkv.device}")
    _check(qkv, bias, mask, num_heads)
    b, w, t, c3 = qkv.shape
    c = c3 // 3
    check_saved("dout", dout, qkv, (b, w, t, c), qkv.dtype)
    check_saved("out", out, qkv, (b, w, t, c), qkv.dtype)
    check_saved("lse", lse, qkv, (b * w, num_heads, t), torch.float32)
    code = _build.dtype_code(qkv, "packed_attention_bwd")
    scale = (c // num_heads) ** -0.5 if scale is None else scale
    dev = qkv.device
    geo = bwd_geometry(t, c // num_heads)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b * w, num_heads, t), dtype=torch.float32, device=dev)
    dbias = partial = None
    n_chunks = 1
    if bias is not None and need_dbias:
        n_chunks = _dbias_chunks(b * w, -(-t // ROWS) * -(-t // TILE) * num_heads)
        dbias = torch.empty_like(bias)
        partial = torch.empty((n_chunks, num_heads, t, t), dtype=torch.float32, device=dev)
    lib = _build.load("packed_attention_bwd", _BWD_SIGNATURES)
    with span("kernel.packed_attention_bwd"):
        rc = lib.packed_attention_bwd(
            qkv.data_ptr(), _ptr(bias), _ptr(mask), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dqkv.data_ptr(), delta.data_ptr(), _ptr(partial), _ptr(dbias),
            b, w, t, c, num_heads, bias.shape[0] if bias is not None else 1,
            mask.shape[0] if mask is not None else 1, float(scale), n_chunks, *geometry_args(geo), code, _build.stream_ptr(dev),
        )
    _build.check(lib, rc, "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    return dqkv, dbias


packed_attention_bwd.launches = 0


class PackedAttentionFunction(torch.autograd.Function):
    """Packed MHSA under autograd: forward and backward each go through their
    wrapper (kernel on CUDA tensors, plain version on CPU tensors).  Saves
    ``(qkv, bias, mask, out, lse)``; the probabilities are rebuilt from them.
    The bias gradient is computed only when autograd asks for it."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads, scale):
        out, lse = packed_attention_fwd(qkv, bias, mask, num_heads, scale, return_lse=True)
        ctx.save_for_backward(qkv, bias, mask, out, lse)
        ctx.geometry = (num_heads, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask, out, lse = ctx.saved_tensors
        dqkv, dbias = packed_attention_bwd(
            qkv, bias, mask, out, lse, dout.contiguous(), *ctx.geometry,
            need_dbias=bias is not None and ctx.needs_input_grad[1])
        return dqkv, dbias, None, None, None


def packed_attention(
    qkv: torch.Tensor,
    bias: torch.Tensor | None,
    mask: torch.Tensor | None,
    num_heads: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Differentiable packed MHSA (to qkv and bias), qkv [B, W, T, 3C] ->
    [B, W, T, C].  Where no gradient can be asked for, the forward wrapper is
    called directly."""
    wants_grad = qkv.requires_grad or (bias is not None and bias.requires_grad)
    if not (torch.is_grad_enabled() and wants_grad):
        return packed_attention_fwd(qkv, bias, mask, num_heads, scale)
    return PackedAttentionFunction.apply(qkv, bias, mask, num_heads, scale)
