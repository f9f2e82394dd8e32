"""The fused attention half of a Swin block: CUDA kernels and plain versions.

``attn_half_fwd`` replaces the TPU kernel ``_fwd_kernel`` in
``ego_moment_cle_vit_tpu/ops/pallas/attn_half.py`` (reached through
``fused_attn_half_spatial``): one pass per window computes

    y = x + proj(window_attention(qkv(LayerNorm(x))))

from the pre-LN activation in image layout ``[B, Hp, Wp, C]``
(``csrc/attn_half_fwd.cu``; bf16: ``csrc/attn_half_fwd_sm90.cuh``, a group
of windows a block on wgmma with the weights streamed through a TMA ring,
blocks walking groups of windows, :func:`fwd_geometry`; fp32: CUDA cores).
``attn_half_bwd`` replaces ``_bwd_kernel`` of the same file
(``csrc/attn_half_bwd.cu``): it recomputes LayerNorm, qkv and
the probabilities from the saved inputs and returns ``dx`` and the seven
parameter gradients, each sum over tokens taken in a fixed order (bf16:
``csrc/attn_half_bwd_sm90.cuh``, every product on wgmma, the attention on
kernel 1b's Hopper core; fp32: CUDA cores).  :func:`bwd_geometry` is how a
launch cuts its work.
``attn_half`` is the differentiable entry point the Swin calls, a
``torch.autograd.Function`` that saves its inputs only, as the TPU VJP does.

Rounding points follow the TPU kernel: ``xn`` rounded to the compute type
after an fp32 LayerNorm, ``qkv`` summed in fp32 and rounded, the
probabilities rounded before ``P v``, ``om`` rounded, and ``x + proj``
summed in fp32 and rounded once.  Backward: ``dom``, ``P``, ``ds``, ``dq``,
``dk``, ``dv`` rounded; ``dbqkv`` sums the rounded ``dqkv``; ``dbias`` sums
fp32 ``ds``; ``dbproj`` sums fp32 ``dy``; the LayerNorm backward is fp32.

Weights are in the port's layout: ``wqkv [3C, C]`` and ``wproj [C, C]``,
``[out, in]``.  The bias is per window ``[H, T, T]`` fp32 and the mask
``[nW, T, T]`` fp32 or None, as the window-attention kernel takes them;
windows are attended one at a time, not packed in pairs behind a -100 seal
as on the TPU (``kernels/window_attention.py`` says why that gives the same
numbers).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import window_attention as _wa
from .window_attention import (
    _partition,
    _probabilities,
    _reverse,
    _wide,
    window_attention_bwd_plain,
)

HEAD_DIM = 32  # the kernels' compiled head width
WIDTHS = (128, 256)  # the kernels' compiled channel counts
MAX_WINDOW = 8  # T = ws*ws <= 64 tokens per window
# fp32 backward (CUDA cores): blocks of its per-window kernel, of its
# weight-gradient kernel (64 x 64 output tiles), of its dx kernel (each walks
# 64-row tiles)
_BWD_TARGET_BLOCKS = 2048
_WGRAD_TARGET_BLOCKS = 1024
_DX_MAX_BLOCKS = 1024
_ROWS = 64  # token rows a step of the weight-gradient sums, a tile of the fp32 dx
# bf16 backward (csrc/attn_half_bwd_sm90.cuh): [128][128] qkv / do tiles
# walked by one block an SM; [128][128] weight-gradient tiles, two blocks an
# SM; dx tiles of whole rows ([128][128] at C = 128, [64][256] at 256) walked
# by one block an SM; the rings' stages and shared memory (the header's
# constants)
SMS = 132  # an H100's SMs
_WGRAD_TARGET_BLOCKS_SM90 = 2 * SMS
_BOX = 64 * 64 * 2
_STAGES_SM90 = {"qkv": 4, "dx": 4, "wgrad": 3}

# bf16 forward (csrc/attn_half_fwd_sm90.cuh, Traits): a block is a group of
# windows (three at C = 128, two at 256), one consumer warpgroup each, and a
# producer warpgroup, one block an SM; the weights stream through a ring of
# four 16 KB TMA stages behind each window's xn and om [64][C] and q, k, v
# [64][32] tiles
_FWD_WINDOWS = {128: 3, 256: 2}
_FWD_STAGES = 4
_FWD_STAGE_BYTES = 128 * 64 * 2

_SIGNATURES = {
    "attn_half_fwd": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    )
}
_BWD_SIGNATURES = {
    "attn_half_bwd": (
        [ctypes.c_void_p] * 26 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    )
}


def kernel_supports(hp: int, wp: int, window_size: int, channels: int, num_heads: int) -> bool:
    """Whether the CUDA kernels take this block: heads of 32, C of 128 or
    256, ws <= 8 and a canvas that windows tile."""
    return (channels in WIDTHS and num_heads > 0 and channels % num_heads == 0
            and channels // num_heads == HEAD_DIM and 1 <= window_size <= MAX_WINDOW
            and hp % window_size == 0 and wp % window_size == 0)


def _layer_norm(x: torch.Tensor, ln_g: torch.Tensor, ln_b: torch.Tensor, eps: float):
    """LayerNorm over the last dim in the wide type: (xn, xc, rstd)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * rstd * _wide(ln_g) + _wide(ln_b), xc, rstd


def _forward_parts(x, ln_g, ln_b, wqkv, bqkv, bias, mask, num_heads, ws, eps):
    """What forward and backward share: (x wide, xn rounded, xc, rstd, qkv
    rounded, om rounded)."""
    dt = x.dtype
    b, hp, wp, c = x.shape
    x32 = _wide(x)
    xn, xc, rstd = _layer_norm(x32, ln_g, ln_b, eps)
    xn = xn.to(dt)
    qkv = (torch.matmul(_wide(xn), _wide(wqkv).transpose(0, 1)) + _wide(bqkv)).to(dt)
    q, k, v = _partition(qkv, 3, num_heads, ws)
    probs = _probabilities(q, k, bias, mask, (c // num_heads) ** -0.5)
    om = _reverse(torch.matmul(_wide(probs.to(dt)), v), b, hp, wp, ws).to(dt)
    return x32, xn, xc, rstd, qkv, om


def attn_half_plain(
    x: torch.Tensor,
    ln_g: torch.Tensor,
    ln_b: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    num_heads: int,
    window_size: int,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, fp32 inside (fp64 for
    fp64 input), at the kernel's rounding points.

    x [B, Hp, Wp, C] (pre-LN, padded and rolled by the caller); ln_g, ln_b
    [C]; wqkv [3C, C], bqkv [3C], wproj [C, C], bproj [C] in x's dtype; bias
    [H, T, T] fp32; mask [nW, T, T] fp32 or None -> y [B, Hp, Wp, C] in x's
    dtype, the residual applied.
    """
    x32, _, _, _, _, om = _forward_parts(x, ln_g, ln_b, wqkv, bqkv, bias, mask, num_heads,
                                         window_size, ln_eps)
    proj = torch.matmul(_wide(om), _wide(wproj).transpose(0, 1)) + _wide(bproj)
    return (x32 + proj).to(x.dtype)


def attn_half_bwd_plain(
    x: torch.Tensor,
    ln_g: torch.Tensor,
    ln_b: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    dy: torch.Tensor,
    num_heads: int,
    window_size: int,
    ln_eps: float = 1e-5,
) -> tuple:
    """Plain PyTorch version of the backward kernel, an explicit VJP.

    Returns (dx in x's dtype, dln_g, dln_b, dwqkv, dbqkv, dwproj, dbproj,
    dbias), the parameter gradients fp32 (fp64 for fp64 input) in the
    parameters' layouts.  The mask gets none.
    """
    del bproj  # the gradient does not depend on it
    dt = x.dtype
    c = x.shape[-1]
    x32, xn, xc, rstd, qkv, om = _forward_parts(x, ln_g, ln_b, wqkv, bqkv, bias, mask,
                                                num_heads, window_size, ln_eps)
    dy32 = _wide(dy)
    dom = torch.matmul(_wide(dy), _wide(wproj)).to(dt)
    dqkv, dbias = window_attention_bwd_plain(qkv, bias, mask, dom, num_heads, window_size,
                                             (c // num_heads) ** -0.5)
    dqkv2 = _wide(dqkv).reshape(-1, 3 * c)
    dwproj = torch.matmul(_wide(dy).reshape(-1, c).transpose(0, 1), _wide(om).reshape(-1, c))
    dwqkv = torch.matmul(dqkv2.transpose(0, 1), _wide(xn).reshape(-1, c))
    dxn = torch.matmul(dqkv2, _wide(wqkv)).reshape(x.shape)
    xhat = xc * rstd
    dxhat = dxn * _wide(ln_g)
    dx_ln = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    tokens = tuple(range(x.dim() - 1))
    return ((dy32 + dx_ln).to(dt), (dxn * xhat).sum(dim=tokens), dxn.sum(dim=tokens), dwqkv,
            dqkv2.sum(dim=0), dwproj, dy32.sum(dim=tokens), dbias)


def _check(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, num_heads, ws):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, Hp, Wp, C], got {tuple(x.shape)}")
    b, hp, wp, c = x.shape
    if not kernel_supports(hp, wp, ws, c, num_heads):
        raise ValueError(f"the kernel takes C in {WIDTHS} with C / heads == {HEAD_DIM} and "
                         f"ws <= {MAX_WINDOW} dividing Hp, Wp; got C={c}, heads={num_heads}, "
                         f"ws={ws}, Hp={hp}, Wp={wp}")
    nt = ws * ws
    nw = (hp // ws) * (wp // ws)
    want = [("wqkv", wqkv, (3 * c, c), x.dtype), ("bqkv", bqkv, (3 * c,), x.dtype),
            ("wproj", wproj, (c, c), x.dtype), ("bproj", bproj, (c,), x.dtype),
            ("ln_g", ln_g, (c,), torch.float32), ("ln_b", ln_b, (c,), torch.float32),
            ("bias", bias, (num_heads, nt, nt), torch.float32)]
    if mask is not None:
        want.append(("mask", mask, (nw, nt, nt), torch.float32))
    for name, t, shape, dtype in want:
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)} on {x.device}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    for name, t in [("x", x)] + [(n, t) for n, t, _, _ in want]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (16-byte loads)")


def _pointer(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def fwd_geometry(b: int, hp: int, wp: int, c: int, heads: int, ws: int, sms: int) -> dict:
    """How the bf16 :func:`attn_half_fwd` cuts its work: ``windows`` (image,
    window) pairs taken ``windows_per_block`` at a time (``groups``, the last
    one part empty where the count does not divide) by ``blocks`` blocks,
    about one wave of one block on each of the card's ``sms`` SMs, block i
    walking groups i, i + blocks, ...  Per group the weights stream through
    ``stages_per_group`` ring stages (64 steps of the contraction each: a
    head's q, k, v rows, then Wproj's rows in passes of 128 output columns).
    ``smem`` is the shared memory a block asks for (what the kernel
    checks)."""
    if not kernel_supports(hp, wp, ws, c, heads):
        raise ValueError(f"the kernel takes C in {WIDTHS} with C / heads == {HEAD_DIM} and "
                         f"ws <= {MAX_WINDOW} dividing Hp, Wp; got C={c}, heads={heads}, "
                         f"ws={ws}, Hp={hp}, Wp={wp}")
    windows = b * (hp // ws) * (wp // ws)
    per_block = _FWD_WINDOWS[c]
    groups = -(-windows // per_block)
    per_window = 2 * 64 * c * 2 + 3 * 64 * HEAD_DIM * 2  # xn, om; q, k, v
    return {"windows": windows, "windows_per_block": per_block, "groups": groups,
            "blocks": min(groups, sms), "stages_per_group": (heads + c // 128) * (c // 64),
            "stages": _FWD_STAGES,
            "smem": 1024 + per_block * per_window + _FWD_STAGES * _FWD_STAGE_BYTES
            + 16 * _FWD_STAGES}


def attn_half_fwd(
    x: torch.Tensor,
    ln_g: torch.Tensor,
    ln_b: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    num_heads: int,
    window_size: int,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """The fused attention half.  CPU tensors take :func:`attn_half_plain`;
    CUDA tensors launch the kernel (after dtype, shape and contiguity
    checks) or raise.  Counts its launches in ``attn_half_fwd.launches``."""
    args = (x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask)
    if x.device.type == "cpu":
        return attn_half_plain(*args, num_heads, window_size, ln_eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"attn_half_fwd: unsupported device {x.device}")
    _check(*args, num_heads, window_size)
    code = _build.dtype_code(x, "attn_half_fwd")
    b, hp, wp, c = x.shape
    geo = (fwd_geometry(b, hp, wp, c, num_heads, window_size,
                        torch.cuda.get_device_properties(x.device).multi_processor_count)
           if x.dtype == torch.bfloat16 else {"blocks": 0, "smem": 0})
    y = torch.empty_like(x)
    _build.launch(
        f"{__name__}:attn_half_fwd", "attn_half_fwd", _SIGNATURES, x.device,
        *(_pointer(t) for t in args), y.data_ptr(), b, hp, wp, c, num_heads, window_size,
        float((c // num_heads) ** -0.5), float(ln_eps), geo["blocks"], geo["smem"], code,
    )
    return y


attn_half_fwd.launches = 0


def _chunks(n: int, target_blocks: int, blocks_per_chunk: int) -> int:
    """How many chunks ``n`` items are cut into so that about
    ``target_blocks`` blocks run, no chunk empty."""
    want = max(1, -(-target_blocks // blocks_per_chunk))
    per = -(-n // min(n, want))
    return -(-n // per)


def scratch_bytes(x: torch.Tensor, num_heads: int, window_size: int) -> dict:
    """Device scratch of one :func:`attn_half_bwd` call, in bytes, by part."""
    b, hp, wp, c = x.shape
    m = b * hp * wp
    nt = window_size * window_size
    n_win = (hp // window_size) * (wp // window_size)
    geo = bwd_geometry(b, m, c, n_win, num_heads, x.dtype)
    return {
        "xn, om, dqkv (compute type)": m * 5 * c * x.element_size(),
        "LayerNorm statistics": m * 8 if x.dtype == torch.bfloat16 else 0,
        "dbias partials": geo["attn_chunks"] * n_win * num_heads * nt * nt * 4,
        "weight-gradient partials": geo["w_chunks"] * (4 * c * c + 4 * c) * 4,
        "LayerNorm partials": geo["dx_blocks"] * 2 * c * 4,
    }


def bwd_geometry(b: int, m: int, c: int, n_win: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """How :func:`attn_half_bwd` cuts its work: image chunks of the
    per-window attention, token chunks (of 64-token tiles) of the weight
    gradients, blocks of the dx pass; for bf16 also the blocks of the qkv /
    do and weight-gradient launches, each launch's ring stages and shared
    memory (what ``csrc/attn_half_bwd_sm90.cuh`` and the window-attention
    core ask for)."""
    row_tiles = -(-m // _ROWS)
    if dtype != torch.bfloat16:
        tiles = (3 * c // 64) * (c // 64) + (c // 64) ** 2
        return {"attn_chunks": _chunks(b, _BWD_TARGET_BLOCKS, n_win * heads),
                "w_chunks": _chunks(row_tiles, _WGRAD_TARGET_BLOCKS, tiles),
                "dx_blocks": min(row_tiles, _DX_MAX_BLOCKS)}
    w_tiles = 4 * (c // 128) ** 2
    m_tiles = -(-m // 128)
    dx_rows = 128 if c == 128 else 64
    dx_tiles = -(-m // dx_rows)

    def smem(head, stage, stages):
        return 1024 + head + stage * stages + 16 * stages

    attn_chunks = _wa._bwd_chunks(b, n_win * heads, _wa._BWD_TARGET_BLOCKS[torch.bfloat16])
    return {"attn_chunks": attn_chunks, "attn_stages": _wa.SM90_STAGES,
            "w_chunks": _chunks(row_tiles, _WGRAD_TARGET_BLOCKS_SM90, w_tiles),
            "w_tiles": w_tiles, "dx_blocks": min(dx_tiles, SMS), "dx_tiles": dx_tiles,
            "m_tiles": m_tiles,
            "qkv_blocks": min(m_tiles * (4 * c // 128), SMS),
            "smem": {"attention": _wa.SM90_SMEM,
                     "qkv": smem(0, 4 * _BOX, _STAGES_SM90["qkv"]),
                     "dx": smem(8 * 2 * c * 4 + 2048, dx_rows * 128 + (c // 64) * _BOX,
                                _STAGES_SM90["dx"]),
                     "wgrad": smem(1024, 4 * _BOX, _STAGES_SM90["wgrad"])}}


def attn_half_bwd(
    x: torch.Tensor,
    ln_g: torch.Tensor,
    ln_b: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    dy: torch.Tensor,
    num_heads: int,
    window_size: int,
    ln_eps: float = 1e-5,
) -> tuple:
    """VJP of :func:`attn_half_fwd`: (dx, dln_g, dln_b, dwqkv, dbqkv,
    dwproj, dbproj, dbias), the parameter gradients fp32.  CPU tensors take
    :func:`attn_half_bwd_plain`; CUDA tensors launch the kernels or raise.
    One call counts as one launch in ``attn_half_bwd.launches``, whatever
    number of CUDA kernels it runs."""
    args = (x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask)
    if x.device.type == "cpu":
        return attn_half_bwd_plain(*args, dy, num_heads, window_size, ln_eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"attn_half_bwd: unsupported device {x.device}")
    _check(*args, num_heads, window_size)
    if (dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape
            or not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError(f"dy must be a contiguous, 16-byte aligned {x.dtype} "
                         f"{list(x.shape)} on {x.device}, got {dy.dtype} {list(dy.shape)}")
    code = _build.dtype_code(x, "attn_half_bwd")
    b, hp, wp, c = x.shape
    m = b * hp * wp
    nt = window_size * window_size
    n_win = (hp // window_size) * (wp // window_size)
    geo = bwd_geometry(b, m, c, n_win, num_heads, x.dtype)
    sm90 = x.dtype == torch.bfloat16
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx = torch.empty_like(x)
    grads = (f32(c), f32(c), f32(3 * c, c), f32(3 * c), f32(c, c), f32(c),
             f32(num_heads, nt, nt))  # dln_g, dln_b, dwqkv, dbqkv, dwproj, dbproj, dbias
    scratch = (torch.empty((m, c), dtype=x.dtype, device=dev),       # xn
               torch.empty((m, c), dtype=x.dtype, device=dev),       # om
               torch.empty((m, 3 * c), dtype=x.dtype, device=dev),   # dqkv
               f32(geo["attn_chunks"], n_win, num_heads, nt, nt),    # dbias partials
               f32(geo["w_chunks"], 4 * c * c),                      # dwqkv | dwproj partials
               f32(geo["w_chunks"], 4 * c),                          # dbqkv | dbproj partials
               f32(geo["dx_blocks"], 2 * c))                         # dln_g | dln_b partials
    stats = f32(m, 2) if sm90 else None  # each row's LayerNorm mean and rstd
    _build.launch(
        f"{__name__}:attn_half_bwd", "attn_half_bwd", _BWD_SIGNATURES, dev,
        *(_pointer(t) for t in args), dy.data_ptr(), dx.data_ptr(),
        *(t.data_ptr() for t in grads), *(t.data_ptr() for t in scratch), _pointer(stats),
        b, hp, wp, c, num_heads, window_size, float((c // num_heads) ** -0.5), float(ln_eps),
        geo["attn_chunks"], geo["w_chunks"], geo["dx_blocks"], geo.get("qkv_blocks", 0),
        geo.get("attn_stages", 0), geo["smem"]["attention"] if sm90 else 0, code,
    )
    return (dx, *grads)


attn_half_bwd.launches = 0


class AttnHalfFunction(torch.autograd.Function):
    """The fused attention half under autograd: forward and backward each go
    through their wrapper (kernels on CUDA tensors, plain versions on CPU
    tensors).  Saves its inputs only; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, num_heads,
                window_size, ln_eps):
        ctx.save_for_backward(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask)
        ctx.geometry = (num_heads, window_size, ln_eps)
        return attn_half_fwd(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask, num_heads,
                             window_size, ln_eps)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        grads = attn_half_bwd(*saved, dy.contiguous(), *ctx.geometry)
        # each parameter's gradient in the parameter's dtype, as on the TPU
        return (*(g.to(t.dtype) for g, t in zip(grads, saved[:8])), None, None, None, None)


def attn_half(
    x: torch.Tensor,
    ln_g: torch.Tensor,
    ln_b: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    num_heads: int,
    window_size: int,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Differentiable ``x + proj(window_attention(qkv(LN(x))))`` (to x and
    every parameter).  Where no gradient can be asked for, the forward
    wrapper is called directly."""
    args = (x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask)
    if not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args)):
        return attn_half_fwd(*args, num_heads, window_size, ln_eps)
    return AttnHalfFunction.apply(*args, num_heads, window_size, ln_eps)
