"""Spatial-layout shifted-window attention: CUDA kernel and plain version.

``window_attention_fwd`` replaces the TPU kernel ``_fwd_kernel_spatial`` in
``ego_moment_cle_vit_tpu/ops/pallas/window_attention.py`` (reached through
``flash_window_attention_spatial``).  The kernel source and its design note
are in ``csrc/window_attention_fwd.cu``: it is bound by memory, reads each
qkv element once, writes each output once and keeps the ``[T, T]`` logits on
chip (bf16: ``csrc/window_attention_fwd_sm90.cuh``, one warpgroup a (window,
head) walking a chunk of images through a TMA ring, both products on wgmma,
its launch geometry :func:`fwd_geometry`; fp32:
``csrc/window_attention_fwd_fp32.cuh``, shared memory, CUDA cores).

``window_attention_bwd`` replaces ``_bwd_kernel_spatial`` of the same file
(``csrc/window_attention_bwd.cu``): it recomputes the probabilities from qkv,
writes dqkv in the spatial layout (bf16: ``csrc/window_attention_bwd_sm90.cuh``,
windows fed by a TMA ring, all five products on wgmma; fp32: CUDA cores) and
sums the bias gradient through per-block partials and a second, ordered
reduction kernel, so the gradient is the same from run to run.
:func:`bwd_geometry` is how the bf16 launch cuts its work.
``window_attention`` is the differentiable entry point the model calls: a
``torch.autograd.Function`` that saves ``(qkv, bias, mask)`` only, never the
``[T, T]`` probabilities.

Unlike the TPU kernel, windows are not packed in pairs behind a -100
block-diagonal seal: that packing was a TPU layout trick, and the port
attends per ``ws*ws``-token window, which gives the same numbers to rounding.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.trace import span
from . import _build

_SIGNATURES = {
    "window_attention_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int,
    )
}
_BWD_SIGNATURES = {
    "window_attention_bwd": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int,
    )
}
# the backward aims at this many blocks per launch: each block walks a chunk
# of images for one (window, head) and writes one [T, T] bias-gradient
# partial.  bf16: one-warpgroup blocks, three an SM, so that each block's
# TMA ring runs over enough images; fp32 keeps its chunks.
_BWD_TARGET_BLOCKS = {torch.bfloat16: 512, torch.float32: 2048}
HEAD_DIM = 32  # the kernel's compiled head width (every Swin stage in the registry)
MAX_WINDOW = 8  # T = ws*ws <= 64 tokens per window
# the bf16 backward's ring and shared memory (csrc/window_attention_bwd_sm90.cuh):
# three blocks an SM
SM90_STAGES = 2  # images in flight a block
# 1024 bytes of alignment slack, the ring of q, k, v, do tiles of 64 rows and
# a barrier a stage, P~ and ds~, the logit terms
SM90_SMEM = 1024 + SM90_STAGES * (4 * 64 * HEAD_DIM * 2 + 8) + 2 * 64 * 64 * 2 + 128 * 32 * 4
# the bf16 forward's (csrc/window_attention_fwd_sm90.cuh): a ring of q, k, v
# tiles of 64 rows and a barrier a stage, the logit terms; five blocks an SM,
# and a grid of about one wave of them on the card's SMs
FWD_STAGES = 2
FWD_SMEM = 1024 + FWD_STAGES * (3 * 64 * HEAD_DIM * 2 + 8) + 128 * 32 * 4
FWD_BLOCKS_PER_SM = 5


def window_attention_plain(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    num_heads: int,
    window_size: int,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, fp32 inside (fp64 for fp64 input).

    qkv [B, Hp, Wp, 3C]; bias [H, T, T] fp32; mask [nW, T, T] fp32 or None
    (T = ws*ws, nW = (Hp/ws)(Wp/ws) windows, row-major) -> [B, Hp, Wp, C] in
    qkv's dtype.
    """
    b, hp, wp, c3 = qkv.shape
    q, k, v = _partition(qkv, 3, num_heads, window_size)
    probs = _probabilities(q, k, bias, mask, scale)
    return _reverse(torch.matmul(probs, v), b, hp, wp, window_size).to(qkv.dtype)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' compute type: fp32, or fp64 when given fp64."""
    return t if t.dtype == torch.float64 else t.float()


def _partition(x: torch.Tensor, parts: int, num_heads: int, ws: int):
    """[B, Hp, Wp, parts*C] -> ``parts`` tensors [B, nW, H, T, d], window-major."""
    b, hp, wp, pc = x.shape
    d = pc // parts // num_heads
    x = _wide(x).reshape(b, hp // ws, ws, wp // ws, ws, parts, num_heads, d)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(
        parts, b, (hp // ws) * (wp // ws), num_heads, ws * ws, d)
    return tuple(x[i] for i in range(parts))


def _reverse(x: torch.Tensor, b: int, hp: int, wp: int, ws: int) -> torch.Tensor:
    """[B, nW, H, T, d] -> [B, Hp, Wp, H*d]."""
    h, d = x.shape[2], x.shape[4]
    x = x.reshape(b, hp // ws, wp // ws, h, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, hp, wp, h * d)


def _probabilities(q, k, bias, mask, scale):
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale + _wide(bias)[None, None]
    if mask is not None:
        logits = logits + _wide(mask)[None, :, None]
    return torch.softmax(logits, dim=-1)


def window_attention_bwd_plain(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    dout: torch.Tensor,
    num_heads: int,
    window_size: int,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, the same formulas.

    qkv [B, Hp, Wp, 3C], dout [B, Hp, Wp, C] -> (dqkv like qkv, dbias
    [H, T, T] fp32).  The probabilities are recomputed; P is rounded to qkv's
    dtype before ``P^T do`` and ds before the dq / dk products, as in the
    kernel; everything else is fp32 (fp64 for fp64 input).
    """
    b, hp, wp, _ = qkv.shape
    dt = qkv.dtype
    q, k, v = _partition(qkv, 3, num_heads, window_size)
    (do,) = _partition(dout, 1, num_heads, window_size)
    probs = _probabilities(q, k, bias, mask, scale)
    dv = torch.matmul(_wide(probs.to(dt)).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
    dbias = ds.sum(dim=(0, 1))
    ds_c = _wide(ds.to(dt))
    dq = torch.matmul(ds_c, k) * scale
    dk = torch.matmul(ds_c.transpose(-1, -2), q) * scale
    dqkv = torch.cat(
        [_reverse(t, b, hp, wp, window_size) for t in (dq, dk, dv)], dim=-1
    ).to(dt)
    return dqkv, dbias.to(bias.dtype)


def _check(qkv, bias, mask, num_heads, ws):
    if qkv.dim() != 4 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"qkv must be [B, Hp, Wp, 3C], got {tuple(qkv.shape)}")
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if num_heads <= 0 or c % num_heads != 0 or c // num_heads != HEAD_DIM:
        raise ValueError(f"kernel needs C / heads == {HEAD_DIM}, got C={c}, heads={num_heads}")
    if not 1 <= ws <= MAX_WINDOW or hp % ws or wp % ws:
        raise ValueError(f"Hp={hp}, Wp={wp} must be multiples of ws={ws} <= {MAX_WINDOW}")
    nt = ws * ws
    tensors = [("qkv", qkv), ("bias", bias)] + ([("mask", mask)] if mask is not None else [])
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on a 16-byte boundary (the kernel loads 16-byte rows)")
    for name, t in tensors:
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (num_heads, nt, nt):
        raise ValueError(f"bias must be float32 [{num_heads}, {nt}, {nt}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    nw = (hp // ws) * (wp // ws)
    if mask is not None and (mask.dtype != torch.float32 or tuple(mask.shape) != (nw, nt, nt)):
        raise ValueError(f"mask must be float32 [{nw}, {nt}, {nt}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")


def window_attention_fwd(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    num_heads: int,
    window_size: int,
    scale: float,
) -> torch.Tensor:
    """Windowed MHSA straight from the spatial qkv map.

    CPU tensors take :func:`window_attention_plain`; CUDA tensors launch the
    kernel (after dtype, shape and contiguity checks) or raise.  Counts its
    launches in ``window_attention_fwd.launches``.
    """
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, mask, num_heads, window_size, scale)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"window_attention_fwd: unsupported device {qkv.device}")
    _check(qkv, bias, mask, num_heads, window_size)
    code = _build.dtype_code(qkv, "window_attention_fwd")
    b, hp, wp, c3 = qkv.shape
    geo = fwd_geometry(b, hp, wp, c3 // 3, num_heads, window_size,
                       torch.cuda.get_device_properties(qkv.device).multi_processor_count)
    out = torch.empty((b, hp, wp, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("window_attention_fwd", _SIGNATURES)
    with span("kernel.window_attention_fwd"):
        rc = lib.window_attention_fwd(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
            out.data_ptr(), b, hp, wp, c3 // 3, num_heads, window_size, float(scale),
            geo["chunks"], geo["stages"], geo["smem"], code, _build.stream_ptr(qkv.device),
        )
    _build.check(lib, rc, "window_attention_fwd")
    window_attention_fwd.launches += 1
    return out


window_attention_fwd.launches = 0


def _bwd_chunks(batch: int, blocks_per_image: int,
                target: int = _BWD_TARGET_BLOCKS[torch.float32]) -> int:
    """How many image chunks the backward grid gets: about ``target``
    blocks, few enough that the bias-gradient partials stay small, no chunk
    empty."""
    want = max(1, -(-target // blocks_per_image))
    per_block = -(-batch // min(batch, want))
    return -(-batch // per_block)


def fwd_geometry(b: int, hp: int, wp: int, c: int, heads: int, ws: int, sms: int) -> dict:
    """How the bf16 :func:`window_attention_fwd` cuts its work: one block per
    (window position, head) and chunk of images, each walking
    ``images_per_block`` images (the last chunk may hold fewer, none is
    empty) through a TMA ring of ``stages`` images.  A block's set-up is paid
    once for its chunk, so the grid takes as many chunks as one wave of
    ``blocks_per_sm`` blocks on each of the card's ``sms`` SMs leaves room
    for (one chunk where the (window, head) pairs alone fill it).  ``smem``
    is the shared memory a block asks for (what the kernel checks) and
    ``tma_strides`` the byte strides of the 4-D tensor map over qkv, which
    TMA needs in multiples of 16.  The fp32 body takes one block per (image,
    window, head) and ignores all of it."""
    n_win = (hp // ws) * (wp // ws)
    pairs = n_win * heads
    want = max(1, min(b, FWD_BLOCKS_PER_SM * sms // pairs))
    chunks = -(-b // -(-b // want))  # no chunk empty
    return {"windows": n_win, "pairs": pairs, "chunks": chunks,
            "images_per_block": -(-b // chunks), "blocks": pairs * chunks,
            "stages": FWD_STAGES, "smem": FWD_SMEM, "blocks_per_sm": FWD_BLOCKS_PER_SM,
            "tma_strides": tuple(3 * c * 2 * f for f in (1, wp, wp * hp))}


def bwd_geometry(b: int, hp: int, wp: int, c: int, heads: int, ws: int,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """How :func:`window_attention_bwd` cuts its work: one block per (window
    position, head) and chunk of images.  For bf16 also the TMA ring's
    stages, the shared memory a block asks for (what the kernel checks) and
    the byte strides of the two 4-D tensor maps over qkv and dout, which TMA
    needs in multiples of 16."""
    n_win = (hp // ws) * (wp // ws)
    pairs = n_win * heads
    chunks = _bwd_chunks(b, pairs, _BWD_TARGET_BLOCKS[dtype])
    per = -(-b // chunks)
    geo = {"windows": n_win, "pairs": pairs, "chunks": chunks, "images_per_block": per,
           "blocks": pairs * chunks, "stages": 0, "smem": 0, "tma_strides": ()}
    if dtype == torch.bfloat16:
        geo["stages"] = SM90_STAGES
        geo["smem"] = SM90_SMEM
        geo["tma_strides"] = tuple(cols * 2 * f for cols in (3 * c, c) for f in (1, wp, wp * hp))
    return geo


def window_attention_bwd(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    dout: torch.Tensor,
    num_heads: int,
    window_size: int,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """VJP of :func:`window_attention_fwd`: (dqkv, dbias); the mask gets none.

    CPU tensors take :func:`window_attention_bwd_plain`; CUDA tensors launch
    the kernel (after the forward's checks, on ``dout`` too) or raise.  Counts
    its launches in ``window_attention_bwd.launches``.
    """
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, bias, mask, dout, num_heads, window_size, scale)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"window_attention_bwd: unsupported device {qkv.device}")
    _check(qkv, bias, mask, num_heads, window_size)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if (dout.device != qkv.device or dout.dtype != qkv.dtype
            or tuple(dout.shape) != (b, hp, wp, c) or not dout.is_contiguous()):
        raise ValueError(f"dout must be a contiguous {qkv.dtype} [{b}, {hp}, {wp}, {c}] on "
                         f"{qkv.device}, got {dout.dtype} {tuple(dout.shape)} on {dout.device}")
    if dout.data_ptr() % 16:
        raise ValueError("dout must start on a 16-byte boundary")
    code = _build.dtype_code(qkv, "window_attention_bwd")
    nt = window_size * window_size
    geo = bwd_geometry(b, hp, wp, c, num_heads, window_size, qkv.dtype)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((num_heads, nt, nt), dtype=torch.float32, device=qkv.device)
    partial = torch.empty((geo["chunks"], geo["windows"], num_heads, nt, nt),
                          dtype=torch.float32, device=qkv.device)
    lib = _build.load("window_attention_bwd", _BWD_SIGNATURES)
    with span("kernel.window_attention_bwd"):
        rc = lib.window_attention_bwd(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
            dout.data_ptr(), dqkv.data_ptr(), partial.data_ptr(), dbias.data_ptr(),
            b, hp, wp, c, num_heads, window_size, float(scale), geo["chunks"], geo["stages"],
            geo["smem"], code, _build.stream_ptr(qkv.device),
        )
    _build.check(lib, rc, "window_attention_bwd")
    window_attention_bwd.launches += 1
    return dqkv, dbias


window_attention_bwd.launches = 0


class WindowAttentionFunction(torch.autograd.Function):
    """Windowed MHSA under autograd: forward and backward each go through
    their wrapper (kernel on CUDA tensors, plain version on CPU tensors).
    Saves ``(qkv, bias, mask)``; the probabilities are recomputed."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, num_heads, window_size, scale):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.geometry = (num_heads, window_size, scale)
        return window_attention_fwd(qkv, bias, mask, num_heads, window_size, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, mask, dout.contiguous(), *ctx.geometry)
        return dqkv, dbias, None, None, None, None


def window_attention(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    num_heads: int,
    window_size: int,
    scale: float,
) -> torch.Tensor:
    """Differentiable windowed MHSA (to qkv and bias) from the spatial qkv map.
    Where no gradient can be asked for, the forward wrapper is called directly."""
    if not (torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad)):
        return window_attention_fwd(qkv, bias, mask, num_heads, window_size, scale)
    return WindowAttentionFunction.apply(qkv, bias, mask, num_heads, window_size, scale)
