"""Spatial-layout shifted-window attention: CUDA kernel and plain version.

``window_attention_fwd`` replaces the TPU kernel ``_fwd_kernel_spatial`` in
``ego_moment_cle_vit_tpu/ops/pallas/window_attention.py`` (reached through
``flash_window_attention_spatial``).  The kernel source and its design note
are in ``csrc/window_attention_fwd.cu``: it is bound by memory, reads each
qkv element once, writes each output once and keeps the ``[T, T]`` logits on
chip (bf16: registers, both products on the tensor cores; fp32: shared
memory, CUDA cores).

Unlike the TPU kernel, windows are not packed in pairs behind a -100
block-diagonal seal: that packing was a TPU layout trick, and the port
attends per ``ws*ws``-token window, which gives the same numbers to rounding.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SIGNATURES = {
    "window_attention_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    )
}
HEAD_DIM = 32  # the kernel's compiled head width (every Swin stage in the registry)
MAX_WINDOW = 8  # T = ws*ws <= 64 tokens per window


def window_attention_plain(
    qkv: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    num_heads: int,
    window_size: int,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, fp32 inside.

    qkv [B, Hp, Wp, 3C]; bias [H, T, T] fp32; mask [nW, T, T] fp32 or None
    (T = ws*ws, nW = (Hp/ws)(Wp/ws) windows, row-major) -> [B, Hp, Wp, C] in
    qkv's dtype.
    """
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    h, ws = num_heads, window_size
    d, nt = c // h, ws * ws
    nwy, nwx = hp // ws, wp // ws
    x = qkv.float().reshape(b, nwy, ws, nwx, ws, 3, h, d)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nwy * nwx, h, nt, d)
    q, k, v = x[0], x[1], x[2]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale + bias.float()[None, None]
    if mask is not None:
        logits = logits + mask.float()[None, :, None]
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs, v)  # [B, nW, H, T, d]
    out = out.reshape(b, nwy, nwx, h, ws, ws, d).permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(b, hp, wp, c).to(qkv.dtype)


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
    out = torch.empty((b, hp, wp, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("window_attention_fwd", _SIGNATURES)
    rc = lib.window_attention_fwd(
        qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
        out.data_ptr(), b, hp, wp, c3 // 3, num_heads, window_size, float(scale), code,
        _build.stream_ptr(qkv.device),
    )
    _build.check(lib, rc, "window_attention_fwd")
    window_attention_fwd.launches += 1
    return out


window_attention_fwd.launches = 0
