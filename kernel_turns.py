#!/usr/bin/env python3
"""Time the redesigned kernels of this checkout against another's, in turns.

    python3 kernel_turns.py --other DIR [--only KERNELS] [--out FILE]

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``).  On one GPU, each turn is a fresh process that
imports the port from one checkout, builds the kernels it times there (all
nvcc runs at once), and times, with CUDA events (median of 5 samples of 10
launches, after 3 warm-up launches), these kernels at the main paths' calls,
in bf16, and some at a call in fp32:

    3   packed attention forward   qkv [64, 1, 197, 2304], 12 heads (serving)
    3   packed attention forward   qkv [128, 1, 197, 2304], with lse (training)
    6   q-tiled attention forward  qkv [64, 785, 2304] and [128, 785, 2304], 12 heads
    6   q-tiled attention forward  qkv [64, 1025, 3072] and [128, 1025, 3072], 16 heads
    3b  packed attention backward  qkv [128, 1, 197, 2304], 12 heads
    6b  q-tiled attention backward qkv [128, 785, 2304], 12 heads
    6b  q-tiled attention backward qkv [128, 1025, 3072], 16 heads
    2b  GPF backward               tokens [64, 784, 768] and [64, 1024, 1024] x2, dot
    5'' streamed bf16 Newton-Schulz M [64, 1536, 1536] bf16, 5 steps
    5'  bf16 Newton-Schulz         M [64, 1024, 1024] bf16, 5 steps
    5   fp32 Newton-Schulz         M [64, 768, 768] bf16, 5 steps (ViT-Base/448's head)
    5b  the iSQRT's backward       M [64, 1024, 1024] bf16, 5 steps: autograd over the
                                   plain fp32 iteration, as ViT-Large/512's training
                                   step runs it (no kernel)
    7   subspace iSQRT             centred and weighted tokens [64, 784, 1024] and
                                   [64, 49, 1024] bf16, 5 steps (ViT-L/16 at 448's
                                   and Swin-Base/224's heads)
    8   SwiGLU glue                g and u [65600, 2736] bf16, W = 2730 (EVA-02-L/448)
    3, 6 in fp32 (off the main paths) at [8, 1, 197, 2304] and [4, 785, 2304]
    2b in fp32 (off the main paths) at [4, 784, 768]
    1b  window attention backward  qkv [128, 56, 56, 384] H4 ... [128, 7, 7, 3072] H32,
                                   the four Swin-Base stages, windows of 7, shift 0 and 1
    4b  fused attention half bwd   x [128, 56, 56, 128] H4 and [128, 28, 28, 256] H8,
                                   shift 0 and 1
    1   window attention forward   qkv [64, 56, 56, 384] H4 ... [64, 7, 7, 3072] H32 and
                                   the same at batch 128, the four Swin-Base stages,
                                   shift 0 and 1; the four Swin-Large/1280 stages on
                                   their padded canvases, [64, 322, 322, 576] H6 ...
                                   [64, 42, 42, 4608] H48, masks with the pad sentinel,
                                   and their sum over one forward's 24 launches
    2   GPF forward                tokens [64, 49, 1024], [64, 196, 768], [64, 784, 768]
                                   (one tensor twice, and two), [64, 1024, 1024] and
                                   [64, 1600, 1536], dot
    4   fused attention half fwd   x [64, 56, 56, 128] H4 and [64, 28, 28, 256] H8 and
                                   the same at batch 128, shift 0 and 1
    e2e serving whole, ms a batch  Swin-Large/1280 (uint8 [64, 1463, 1463, 3]),
                                   ViT-Large/512 (uint8 [64, 600, 600, 3]) and
                                   Swin-Base/224 under fused_half (uint8
                                   [64, 256, 256, 3]) through make_infer_fn
                                   (chip_smoke.py's configurations, seeded
                                   weights); not in the default list

and, in the same turn and process, a library yardstick on the same inputs,
whose own spread across turns decides whether a kernel is at or under it:
SDPA (``scaled_dot_product_attention``, forward or backward) for attention,
autograd of one fp32 ``bmm`` Gram for 2b (part of its work only), and the
same bf16 iteration on cuBLAS (``bmm``, ``baddbmm``, each kernel's grouping
and rounding points) for 5'' and 5', the same iteration on cuBLAS in fp32 (``bmm``,
``baddbmm``) for 5, the plain fp32 route (``isqrt_cov_subspace``) for 7, the
composition it replaces (``swiglu_norm_plain``) for 8, SDPA on the partitioned windows with
bias + mask as its float mask for 1, one fp32 ``bmm`` Gram for 2 (part of its work), SDPA's
backward on the partitioned windows for 1b (without
the bias gradient, and again with the float mask a leaf that takes one:
``library_dbias``), and for 4b autograd of the port's unfused route
(LayerNorm, ``linear``, kernel 1 / 1b of the same checkout, ``linear``,
add), for 4 that route's forward (and, as ``library_sdpa``, LayerNorm,
``linear``, SDPA on the partitioned windows, ``linear``, add).  2b, 5'', 5',
1b and 4b are also profiled once a turn (torch.profiler, 5 calls), which
splits their time among the launches inside one call.  5, 5', 5'', 7 and 8 print their
bound beside their time: the larger of their bytes over 3.35 TB/s and their operations over
the bf16 peak, for 5, 5' and 5'' from their own modules of ``h100_bench/kernel_work``, for 7
and 8 from the package's ``subspace_isqrt.bound_flops`` / ``bound_bytes`` and
``swiglu_norm.bound_bytes``.  5' and 5'' also print how far from their plain version,
which rounds where they round, they are, beside the other grouping's and the cuBLAS
iteration's distance (err / tol of ``kernel_checks.TOL_NS_BF16``; printed, not
enforced).  Each
turn hashes what its kernels return at every call (out and lse, dqkv; for 2b
dc and the token gradients apart; for 1b dqkv and dbias apart; for 4b dx and
each parameter gradient apart; for 1, 2, 4, 5, 5', 5'', 7 and 8 out; for 5b dM; for e2e
the logits), from the same seeded
inputs, so the two checkouts are compared bit for bit too.

The turns run other, this, this, other, so that drift of the card hits both
alike.  ``--only`` takes a comma-separated list of kernel names (3, 6, 3b, 6b,
2b, 5'', 5', 5, 5b, 7, 8, 1b, 4b, 1, 2, 4, e2e) and times only their calls.
Prints the card's name and power limit, each turn's times, the best of each
side, and a last line of
JSON {"card": ..., "shapes": {shape: {"other": [ms, ms], "this": [ms, ms],
"library": [ms, ms, ms, ms], "library_dbias": [...] (1b only),
"library_sdpa": [...] (4 only), "bound": ms (5, 5', 5'', 7 and 8), "apart":
{"other": {...}, "this": {...}} (5' and 5''), "same_bits": {part: bool},
"split": {"other": {launch: ms}, "this": {...}}}}, "swinL1280_forward_ms":
{"other": ms, "this": ms, "library": ms} (with every padded shape of 1)}; --out
writes that JSON to a file too.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import statistics
import subprocess
import sys

# Swin-Large/1280's stages on their padded canvases: (Hp, C, heads), and the
# blocks of each (half of them shifted)
SWINL1280 = ((322, 192, 6), (161, 384, 12), (84, 768, 24), (42, 1536, 48))
SWINL1280_BLOCKS = {322: 2, 161: 2, 84: 18, 42: 2}
# (name, kind, batch, tokens or N, width C or D, heads)
SHAPES = (("3 [64,1,197,2304] H12", "packed_fwd", 64, 197, 768, 12),
          ("3 [128,1,197,2304] H12 lse", "packed_fwd_lse", 128, 197, 768, 12),
          ("6 [64,785,2304] H12", "tiled_fwd", 64, 785, 768, 12),
          ("6 [128,785,2304] H12", "tiled_fwd", 128, 785, 768, 12),
          ("6 [64,1025,3072] H16", "tiled_fwd", 64, 1025, 1024, 16),
          ("6 [128,1025,3072] H16", "tiled_fwd", 128, 1025, 1024, 16),
          ("3b [128,1,197,2304] H12", "packed_bwd", 128, 197, 768, 12),
          ("6b [128,785,2304] H12", "tiled_bwd", 128, 785, 768, 12),
          ("6b [128,1025,3072] H16", "tiled_bwd", 128, 1025, 1024, 16),
          ("2b [64,784,768] x2 dot", "gpf_bwd", 64, 784, 768, 0),
          ("2b [64,1024,1024] x2 dot", "gpf_bwd", 64, 1024, 1024, 0),
          ("5'' [64,1536,1536] k5", "ns_streamed", 64, 1536, 1536, 0),
          ("3 fp32 [8,1,197,2304] H12 lse", "packed_fwd_lse", 8, 197, 768, 12),
          ("6 fp32 [4,785,2304] H12", "tiled_fwd", 4, 785, 768, 12),
          ("2b fp32 [4,784,768] x2 dot", "gpf_bwd", 4, 784, 768, 0),
          ("1b [128,56,56,384] H4 s0", "wa_bwd", 128, 56, 128, 4),
          ("1b [128,56,56,384] H4 s1", "wa_bwd", 128, 56, 128, 4),
          ("1b [128,28,28,768] H8 s0", "wa_bwd", 128, 28, 256, 8),
          ("1b [128,28,28,768] H8 s1", "wa_bwd", 128, 28, 256, 8),
          ("1b [128,14,14,1536] H16 s0", "wa_bwd", 128, 14, 512, 16),
          ("1b [128,14,14,1536] H16 s1", "wa_bwd", 128, 14, 512, 16),
          ("1b [128,7,7,3072] H32 s0", "wa_bwd", 128, 7, 1024, 32),
          ("4b [128,56,56,128] H4 s0", "ah_bwd", 128, 56, 128, 4),
          ("4b [128,56,56,128] H4 s1", "ah_bwd", 128, 56, 128, 4),
          ("4b [128,28,28,256] H8 s0", "ah_bwd", 128, 28, 256, 8),
          ("4b [128,28,28,256] H8 s1", "ah_bwd", 128, 28, 256, 8),
          *((f"1 [{b},{hp},{hp},{3 * c}] H{h} s{s}", "wfwd", b, hp, c, h)
            for b in (64, 128) for hp, c, h in ((56, 128, 4), (28, 256, 8), (14, 512, 16),
                                                (7, 1024, 32))
            for s in ((0, 1) if hp > 7 else (0,))),
          *((f"1 [64,{hp},{hp},{3 * c}] H{h} s{s} padded", "wfwd", 64, hp, c, h)
            for hp, c, h in SWINL1280 for s in (0, 1)),
          ("2 [64,49,1024] dot", "gfwd", 64, 49, 1024, 0),
          ("2 [64,196,768] dot", "gfwd", 64, 196, 768, 0),
          ("2 [64,784,768] dot", "gfwd", 64, 784, 768, 0),
          ("2 [64,784,768] x2 dot", "gfwd", 64, 784, 768, 0),
          ("2 [64,1024,1024] dot", "gfwd", 64, 1024, 1024, 0),
          ("2 [64,1600,1536] dot", "gfwd", 64, 1600, 1536, 0),
          ("5' [64,1024,1024] k5", "ns_bf16", 64, 1024, 1024, 0),
          ("5 [64,768,768] k5", "nsfp32", 64, 784, 768, 0),
          ("5b [64,1024,1024] k5", "ns_bwd", 64, 1024, 1024, 0),
          ("7 [64,784,1024] k5", "si", 64, 784, 1024, 0),
          ("7 [64,49,1024] k5", "si", 64, 49, 1024, 0),
          ("8 [65600,2736] W2730", "sn", 64 * 1025, 2736, 2730, 0),
          *((f"4 [{b},{hp},{hp},{c}] H{h} s{s}", "ah_fwd", b, hp, c, h)
            for b in (64, 128) for hp, c, h in ((56, 128, 4), (28, 256, 8)) for s in (0, 1)),
          ("e2e serve-swinL-1280 b64", "serve", 64, 0, 0, 0),
          ("e2e serve-vitL-512 b64", "serve", 64, 0, 0, 0),
          ("e2e serve-swinB-224-fused b64", "serve", 64, 0, 0, 0))
WS = 7  # Swin's window
SOURCES = {"packed": ("packed_attention_fwd", "packed_attention_bwd"),
           "tiled": ("flash_attention_fwd", "flash_attention_bwd"),
           "gpf": ("gpf_bwd",), "ns": ("newton_schulz_bf16_streamed", "newton_schulz_bf16"),
           "wa": ("window_attention_bwd",),
           "ah": ("attn_half_fwd", "attn_half_bwd", "window_attention_fwd",
                  "window_attention_bwd"),
           "wfwd": ("window_attention_fwd",), "gfwd": ("gpf_fwd",),
           "nsfp32": ("newton_schulz",), "si": ("subspace_isqrt",), "sn": ("swiglu_norm",),
           "serve": ("window_attention_fwd", "gpf_fwd", "newton_schulz_bf16_streamed",
                     "newton_schulz_bf16", "flash_attention_fwd", "attn_half_fwd")}
# the e2e entries' configurations in chip_smoke.py
SERVED = {"serve-swinL-1280": "SWINL1280", "serve-vitL-512": "VITL512",
          "serve-swinB-224-fused": "SWIN_FH"}
ORDER = ("other", "this", "this", "other")
NS_ITERS, NS_EPS = 5, 1e-5


def kernel_of(name: str) -> str:
    return name.split()[0]


def time_ms(fn, warm: int = 3, samples: int = 5, reps: int = 10) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def launch_split(fn, reps: int = 5) -> dict:
    """Device ms a call of each kernel that ``fn`` launches (torch.profiler
    over ``reps`` calls), keyed by the kernel function's short name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if not us or ev.key.startswith(("aten::", "cuda", "Memcpy", "Memset")):
            continue
        # "void (anonymous namespace)::gpf_bwd_w_kernel<__nv_bfloat16>(...)" -> gpf_bwd_w_kernel
        head = re.split(r"[<(]", ev.key.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
        short = head.split()[-1].split("::")[-1] if head.split() else ev.key[:40]
        split[short] = split.get(short, 0.0) + us / 1e3 / reps
    return split


def digest(result) -> str:
    """sha256 of the bits of a kernel's result: a tensor, or a tuple of them
    (None entries skipped)."""
    import torch

    h = hashlib.sha256()
    for t in result if isinstance(result, tuple) else (result,):
        if t is not None:
            bits = {2: torch.int16, 4: torch.int32}[t.element_size()]  # read as integers
            h.update(t.contiguous().view(-1).view(bits).cpu().numpy().tobytes())
    return h.hexdigest()


def sdpa(qkv, heads: int, backward: bool):
    """SDPA on the same inputs, the forward or its backward (dq, dk, dv)."""
    import torch

    b, t, c3 = qkv.shape[0], qkv.shape[-2], qkv.shape[-1]
    d = c3 // 3 // heads
    x = qkv.reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = (x[i].contiguous().requires_grad_(backward) for i in range(3))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    if not backward:
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    do = torch.randn_like(o)
    return lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)


def gram_backward(tokens, cot):
    """Autograd of one fp32 bmm Gram (2b's yardstick; part of its work only)."""
    import torch

    tf = tokens.float().requires_grad_()
    gram = torch.bmm(tf, tf.transpose(1, 2))
    return lambda: torch.autograd.grad(gram, tf, cot, retain_graph=True)


def window_bias_mask(g, hp: int, heads: int, shifted: bool, h: int | None = None):
    """A Swin block's relative-position bias [H, 49, 49] (its table drawn at
    std 1, as trained tables reach) and, when shifted, its shift mask; on a
    canvas padded from ``h`` real rows to ``hp``, a mask with the pad
    sentinel, shifted or not."""
    import torch

    from ego_moment_cle_vit_tpu_torch.models.swin import _attn_mask, _relative_position_index

    nt = WS * WS
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device="cuda")
    table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device="cuda")
    bias = table[idx].reshape(nt, nt, heads).permute(2, 0, 1).contiguous()
    h = hp if h is None else h
    mask = (torch.as_tensor(_attn_mask(h, h, hp, hp, WS, WS // 2 if shifted else 0),
                            device="cuda") if shifted or h != hp else None)
    return bias, mask


def window_sdpa_forward(qkv, bias, mask, heads: int):
    """SDPA on the same windows, partitioned beforehand (the copies are not
    timed), with bias + mask as its float mask: kernel 1's yardstick, never
    the port's."""
    import torch

    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    d, nt, nw = c // heads, WS * WS, (hp // WS) * (wp // WS)
    x = qkv.reshape(b, hp // WS, WS, wp // WS, WS, 3, heads, d)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nw * heads, nt, d)
    q, k, v = (x[i].contiguous() for i in range(3))
    del x
    am = bias[None] + (mask[:, None] if mask is not None else 0.0)
    am = am.expand(nw, heads, nt, nt).reshape(nw * heads, nt, nt).to(qkv.dtype)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                                    scale=d ** -0.5)


def window_sdpa_backward(qkv, bias, mask, heads: int, dbias: bool):
    """SDPA's backward on the same windows, partitioned beforehand, with bias
    + mask as its float mask: dq, dk, dv, and with ``dbias`` the mask's
    gradient too (the mask a leaf that takes one).  A yardstick, never the
    port's."""
    import torch

    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    d, nt, nw = c // heads, WS * WS, (hp // WS) * (wp // WS)
    x = qkv.reshape(b, hp // WS, WS, wp // WS, WS, 3, heads, d)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nw * heads, nt, d)
    q, k, v = (x[i].contiguous().requires_grad_() for i in range(3))
    am = bias[None] + (mask[:, None] if mask is not None else 0.0)
    am = am.expand(nw, heads, nt, nt).reshape(nw * heads, nt, nt).to(qkv.dtype)
    leaves = (q, k, v, am.requires_grad_()) if dbias else (q, k, v)
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=d ** -0.5)
    do = torch.randn_like(o)
    return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)


def attn_half_inputs(g, batch: int, hp: int, c: int, heads: int, shifted: bool, dtype) -> tuple:
    """(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask) for one fused
    Swin block: LayerNorm parameters near their init, Dense weights at lecun
    scale, the bias table at std 1."""
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    bias, mask = window_bias_mask(g, hp, heads, shifted)
    return (randn(batch, hp, hp, c).to(dtype), 1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
            randn(3 * c, c, scale=c ** -0.5).to(dtype), randn(3 * c, scale=0.1).to(dtype),
            randn(c, c, scale=c ** -0.5).to(dtype), randn(c, scale=0.1).to(dtype), bias, mask)


def attention_half_by_library(args: tuple, heads: int):
    """The same block as PyTorch's own calls: layer_norm, linear, SDPA over
    the partitioned windows with bias + mask as its float mask (partition and
    reverse copies included), linear, add.  A yardstick, never the port's."""
    import torch

    x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask = args
    b, hp, wp, c = x.shape
    nw, nt, d = (hp // WS) * (wp // WS), WS * WS, c // heads
    xn = torch.nn.functional.layer_norm(x.float(), (c,), ln_g, ln_b, 1e-5).to(x.dtype)
    qkv = torch.nn.functional.linear(xn, wqkv, bqkv)
    qkv = qkv.reshape(b, hp // WS, WS, wp // WS, WS, 3, heads, d)
    qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nw, heads, nt, d)
    am = bias[None] + (mask[:, None] if mask is not None else 0.0)
    am = am.expand(b, nw, heads, nt, nt).reshape(b * nw, heads, nt, nt).to(x.dtype)
    o = torch.nn.functional.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=am,
                                                         scale=d ** -0.5)
    om = o.reshape(b, hp // WS, wp // WS, heads, WS, WS, d).permute(0, 1, 4, 2, 5, 3, 6)
    return x + torch.nn.functional.linear(om.reshape(b, hp, wp, c), wproj, bproj)


def ns_fp32_library(m):
    """Kernel 5's iteration on cuBLAS in fp32, each update one ``baddbmm``: a
    yardstick, never the port's."""
    import torch

    mf = m.float()
    tr = torch.diagonal(mf, dim1=-2, dim2=-1).sum(-1)[:, None, None] + NS_EPS
    z = mf / tr
    y = torch.eye(m.shape[-1], device=m.device).expand_as(z).contiguous()
    for i in range(NS_ITERS):
        t = torch.bmm(z, y)
        y_next = torch.baddbmm(y, y, t, beta=1.5, alpha=-0.5)
        if i + 1 < NS_ITERS:
            z = torch.baddbmm(z, t.transpose(1, 2), z, beta=1.5, alpha=-0.5)
        y = y_next
    return (y / torch.sqrt(tr)).to(m.dtype)


def ns_bf16_library(m, streamed: bool):
    """The bf16 iteration on cuBLAS at the kernels' rounding points, the
    products grouped as 5'' (``streamed``) or 5' groups them: bf16 ``bmm``
    for the products and ``baddbmm`` for the update, with the first step's
    exact copies skipped as the kernels skip them.  A yardstick, never the
    port's."""
    import torch

    mf = m.float()
    tr = torch.diagonal(mf, dim1=-2, dim2=-1).sum(-1)[:, None, None] + NS_EPS
    mn = (mf / tr).to(torch.bfloat16)
    eye = torch.eye(m.shape[-1], device=m.device)
    y = (1.5 * eye - 0.5 * mn.float()).to(torch.bfloat16)
    for _ in range(NS_ITERS - 1):
        if streamed:
            p = torch.bmm(torch.bmm(y, mn), y)
            y = torch.baddbmm(y, p, y, beta=1.5, alpha=-0.5)
        else:
            t2 = torch.bmm(mn, torch.bmm(y, y))
            y = torch.baddbmm(y, y, t2, beta=1.5, alpha=-0.5)
    return (y.float() / torch.sqrt(tr)).to(m.dtype)


def attention_half_unfused(args: tuple, heads: int):
    """The port's default route for a fused block: LayerNorm, Dense, kernel 1
    (1b under autograd), Dense, add."""
    import torch

    from ego_moment_cle_vit_tpu_torch.kernels.window_attention import window_attention

    x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask = args
    c = x.shape[-1]
    xn = torch.nn.functional.layer_norm(x.float(), (c,), ln_g, ln_b, 1e-5).to(x.dtype)
    qkv = torch.nn.functional.linear(xn, wqkv, bqkv)
    om = window_attention(qkv, bias, mask, heads, WS, (c // heads) ** -0.5)
    return x + torch.nn.functional.linear(om, wproj, bproj)


def bound_ms(kind: str, b: int, t: int, c: int) -> float | None:
    """The bound of one bf16 call of 5, 5', 5'' (their modules of
    ``h100_bench/kernel_work``), 7 or 8 (the package's ``bound_flops`` /
    ``bound_bytes``), from this checkout; None for the other kernels."""
    import importlib

    from ego_moment_cle_vit_tpu_torch.kernels import subspace_isqrt as si
    from ego_moment_cle_vit_tpu_torch.kernels import swiglu_norm as sn
    from h100_bench.kernel_work import bound_s

    dense = {"nsfp32": "newton_schulz_isqrt_fp32_fwd", "ns_bf16": "newton_schulz_isqrt_bf16_fwd",
             "ns_streamed": "newton_schulz_isqrt_bf16_streamed_fwd"}
    if kind in dense:
        work = importlib.import_module(f"h100_bench.kernel_work.{dense[kind]}")
        spec = {"architecture": {"num_features": c},
                "port_config": {"model": {"bf16": True, "moment": {"isqrt_iterations": NS_ITERS}}}}
        ((nbytes, flops),) = work.work(spec, b, True)
        return bound_s(nbytes, flops, work.DTYPE) * 1e3
    if kind == "si":
        return bound_s(si.bound_bytes(b, t, c, 2), si.bound_flops(b, t, c, NS_ITERS, True),
                       "bfloat16") * 1e3
    if kind == "sn":
        return bound_s(sn.bound_bytes(b, t), 0.0, "bfloat16") * 1e3
    return None


def worker(only: set) -> None:
    """One turn: time every shape with the port of the working directory (put
    ahead of this script's own directory, which Python searches first)."""
    sys.path.insert(0, os.getcwd())
    import torch

    from ego_moment_cle_vit_tpu_torch.kernels import _build
    from ego_moment_cle_vit_tpu_torch.kernels import attn_half as ah
    from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as fa
    from ego_moment_cle_vit_tpu_torch.kernels import gpf
    from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as ns
    from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as pa
    from ego_moment_cle_vit_tpu_torch.kernels import subspace_isqrt as si
    from ego_moment_cle_vit_tpu_torch.kernels import swiglu_norm as sn
    from ego_moment_cle_vit_tpu_torch.kernels import window_attention as wa
    from ego_moment_cle_vit_tpu_torch.ops.moments import isqrt_cov_subspace
    from kernel_checks import PADDED, TOL_NS_BF16, subspace_inputs

    shapes = [s for s in SHAPES if kernel_of(s[0]) in only]
    sources = {src for _, kind, *_ in shapes for src in SOURCES[kind.split("_")[0]]}
    _build.build(tuple(sorted(sources)))  # all nvcc runs at once

    # the backward of earlier checkouts took no out and lse
    takes_lse = "lse" in inspect.signature(pa.packed_attention_bwd).parameters
    print(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(pa.__file__)))),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for name, kind, b, t, c, h in shapes:
        dtype = torch.float32 if "fp32" in name else torch.bfloat16
        split = lib_dbias = lib_sdpa = apart = None
        if kind == "serve":
            # the whole serving path: chip_smoke.py's configuration from the
            # same checkout, weights from seed 0
            import chip_smoke

            from ego_moment_cle_vit_tpu_torch import create_model, make_infer_fn

            family = getattr(chip_smoke, SERVED[name.split()[1]])
            aug, images = chip_smoke.family_inputs(family, g)
            model = create_model(family["config"], num_classes=80, device="cuda", seed=0)
            infer = make_infer_fn(model, aug)
            fn = lambda: infer(images)  # noqa: E731
            digests = {"logits": digest(fn())}
            res[name] = {"ms": time_ms(fn, warm=2, samples=3, reps=3), "library": None,
                         "digests": digests, "split": None}
            del model, infer, fn, images
            torch.cuda.empty_cache()
            continue
        if kind == "wfwd":
            bias, mask = window_bias_mask(g, t, h, " s1" in name, PADDED.get(t))
            qkv = torch.randn(b, t, t, 3 * c, generator=g, device="cuda").to(dtype)
            fn = lambda: wa.window_attention_fwd(qkv, bias, mask, h, WS,  # noqa: E731
                                                 (c // h) ** -0.5)
            lib = window_sdpa_forward(qkv, bias, mask, h)
            digests = {"out": digest(fn())}
        elif kind == "gfwd":
            ta = torch.randn(b, t, c, generator=g, device="cuda").to(dtype)
            tp = (torch.randn(b, t, c, generator=g, device="cuda").to(dtype) if " x2 " in name
                  else ta)
            coeffs = torch.nn.functional.softplus(torch.rand(3, 3, generator=g, device="cuda")
                                                  * 0.1)
            fn = lambda: gpf.gpf_fwd(ta, tp, coeffs, "dot", 1e-6, True)  # noqa: E731
            tf = ta.float()
            lib = lambda: torch.bmm(tf, tf.transpose(1, 2))  # noqa: E731
            digests = {"out": digest(fn())}
        elif kind == "wa_bwd":
            bias, mask = window_bias_mask(g, t, h, name.endswith("s1"))
            qkv = torch.randn(b, t, t, 3 * c, generator=g, device="cuda").to(dtype)
            dout = torch.randn(b, t, t, c, generator=g, device="cuda").to(dtype)
            fn = lambda: wa.window_attention_bwd(qkv, bias, mask, dout, h, WS,  # noqa: E731
                                                 (c // h) ** -0.5)
            lib = window_sdpa_backward(qkv, bias, mask, h, dbias=False)
            lib_dbias = window_sdpa_backward(qkv, bias, mask, h, dbias=True)
            dqkv, dbias = fn()
            digests = {"dqkv": digest(dqkv), "dbias": digest(dbias)}
            split = launch_split(fn)
        elif kind == "ah_fwd":
            args = attn_half_inputs(g, b, t, c, h, name.endswith("s1"), dtype)
            fn = lambda: ah.attn_half_fwd(*args, h, WS)  # noqa: E731
            lib = lambda: attention_half_unfused(args, h)  # noqa: E731
            lib_sdpa = lambda: attention_half_by_library(args, h)  # noqa: E731
            digests = {"out": digest(fn())}
        elif kind == "ah_bwd":
            args = attn_half_inputs(g, b, t, c, h, name.endswith("s1"), dtype)
            dy = torch.randn(args[0].shape, generator=g, device="cuda").to(dtype)
            fn = lambda: ah.attn_half_bwd(*args, dy, h, WS)  # noqa: E731
            leaves = [x.detach().clone().requires_grad_() for x in args[:8]]
            y = attention_half_unfused((*leaves, args[8]), h)
            lib = lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)  # noqa: E731
            names = ("dx", "dln_g", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
            digests = dict(zip(names, (digest(r) for r in fn())))
            split = launch_split(fn)
        elif kind == "gpf_bwd":
            ta = torch.randn(b, t, c, generator=g, device="cuda").to(dtype)
            tp = torch.randn(b, t, c, generator=g, device="cuda").to(dtype)
            coeffs = torch.nn.functional.softplus(torch.rand(3, 3, generator=g, device="cuda")
                                                  * 0.1)
            cot = torch.randn(b, t, t, generator=g, device="cuda")
            fn = lambda: gpf.gpf_bwd(ta, tp, coeffs, cot, "dot", 1e-6, True)  # noqa: E731
            lib = gram_backward(ta, cot)
            dta, dtp, dc = fn()
            digests = {"dc": digest(dc), "dX": digest((dta, dtp))}
            split = launch_split(fn)
        elif kind in ("ns_streamed", "ns_bf16"):
            streamed = kind == "ns_streamed"
            n = 1600 if streamed else 1024  # the head's tokens: Swin-Large/1280, ViT-Large/512
            z = torch.randn(b, n, c, generator=g, device="cuda")
            m = (torch.matmul(z.transpose(1, 2), z) / n).to(dtype)
            del z
            kernel = (ns.newton_schulz_isqrt_bf16_streamed_fwd if streamed
                      else ns.newton_schulz_isqrt_bf16_fwd)
            fn = lambda: kernel(m, NS_ITERS, NS_EPS)  # noqa: E731
            lib = lambda: ns_bf16_library(m, streamed)  # noqa: E731
            out = fn()
            digests = {"out": digest(out)}
            split = launch_split(fn)
            plains = (ns.newton_schulz_isqrt_bf16_plain, ns.newton_schulz_isqrt_bf16_streamed_plain)
            plain, other = plains[::-1] if streamed else plains
            ref = plain(m, NS_ITERS, NS_EPS).float()
            rtol, atol = TOL_NS_BF16["full_rank"]
            tol = rtol * ref.abs() + atol * ref.abs().max()
            apart = {what: float(((x.float() - ref).abs() / tol).max()) for what, x in (
                ("kernel", out), ("other grouping", other(m, NS_ITERS, NS_EPS)), ("cuBLAS", lib()))}
            del out, ref, tol
        elif kind == "nsfp32":
            z = torch.randn(b, t, c, generator=g, device="cuda")
            m = (torch.matmul(z.transpose(1, 2), z) / t).to(dtype)
            del z
            fn = lambda: ns.newton_schulz_isqrt_fp32_fwd(m, NS_ITERS, NS_EPS)  # noqa: E731
            lib = lambda: ns_fp32_library(m)  # noqa: E731
            digests = {"out": digest(fn())}
        elif kind == "ns_bwd":
            # ViT-Large/512's training step: M from the head's 1024 tokens
            z = torch.randn(b, t, c, generator=g, device="cuda")
            m = (torch.matmul(z.transpose(1, 2), z) / t).to(dtype)
            cot = torch.randn(m.shape, generator=g, device="cuda").to(dtype)
            del z

            def fn():
                x = m.detach().requires_grad_()
                return torch.autograd.grad(ns.newton_schulz_isqrt_plain(x, NS_ITERS, NS_EPS),
                                           x, cot)[0]

            digests = {"dM": digest(fn())}
            res[name] = {"ms": time_ms(fn, warm=1, samples=3, reps=2), "library": None,
                         "digests": digests, "split": None}
            del fn, m, cot
            torch.cuda.empty_cache()
            continue
        elif kind == "si":
            centered, weighted = subspace_inputs(g, b, t, c, dtype)
            fn = lambda: si.subspace_isqrt_fwd(centered, weighted, NS_ITERS, NS_EPS)  # noqa: E731
            lib = lambda: isqrt_cov_subspace(centered, weighted,  # noqa: E731
                                             NS_ITERS, NS_EPS)
            digests = {"out": digest(fn())}
        elif kind == "sn":
            gu = torch.randn(2, b, t, generator=g, device="cuda")
            gate, value = (1.5 * gu[0]).to(torch.bfloat16), gu[1].to(torch.bfloat16)
            del gu
            w = 1 + 0.3 * torch.randn(c, generator=g, device="cuda")
            bias = 0.3 * torch.randn(c, generator=g, device="cuda")
            fn = lambda: sn.swiglu_norm_fwd(gate, value, w, bias, c, 1e-6)  # noqa: E731
            lib = lambda: sn.swiglu_norm_plain(gate, value, w, bias, c, 1e-6)  # noqa: E731
            digests = {"out": digest(fn())}
        else:
            shape = (b, 1, t, 3 * c) if kind.startswith("packed") else (b, t, 3 * c)
            qkv = torch.randn(*shape, generator=g, device="cuda").to(dtype)
            dout = torch.randn(*shape[:-1], c, generator=g, device="cuda").to(dtype)
            if kind == "packed_fwd":
                fn = lambda: pa.packed_attention_fwd(qkv, None, None, h)  # noqa: E731
            elif kind == "packed_fwd_lse":
                fn = lambda: pa.packed_attention_fwd(qkv, None, None, h,  # noqa: E731
                                                     return_lse=True)
            elif kind == "tiled_fwd":
                fn = lambda: fa.flash_attention_tiled_fwd(qkv, h)  # noqa: E731
            elif kind == "packed_bwd" and takes_lse:
                out, lse = pa.packed_attention_fwd(qkv, None, None, h, return_lse=True)
                fn = lambda: pa.packed_attention_bwd(qkv, None, None, out, lse,  # noqa: E731
                                                     dout, h)
            elif kind == "packed_bwd":
                fn = lambda: pa.packed_attention_bwd(qkv, None, None, dout, h)  # noqa: E731
            else:
                out, lse = fa.flash_attention_tiled_fwd(qkv, h)
                fn = lambda: fa.flash_attention_tiled_bwd(qkv, out, lse, dout, h)  # noqa: E731
            lib = sdpa(qkv, h, kind.endswith("bwd"))
            digests = {"out": digest(fn())}
        res[name] = {"ms": time_ms(fn), "library": time_ms(lib), "digests": digests,
                     "split": split}
        if lib_dbias is not None:
            res[name]["library_dbias"] = time_ms(lib_dbias)
        if lib_sdpa is not None:
            res[name]["library_sdpa"] = time_ms(lib_sdpa)
        if apart is not None:
            res[name]["apart"] = apart
        del fn, lib, lib_dbias, lib_sdpa
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--only", default="3,6,3b,6b,2b,5'',5',5,5b,7,8,1b,4b,1,2,4",
                    help="comma-separated kernels to time (default: all)")
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    only = set(args.only.split(","))
    if args.worker:
        worker(only)
        return 0
    port = "ego_moment_cle_vit_tpu_torch"
    if not args.other or not os.path.isdir(os.path.join(args.other, port)):
        print("kernel_turns: --other must name a checkout of this repository", file=sys.stderr)
        return 2
    shapes = [s[0] for s in SHAPES if kernel_of(s[0]) in only]
    if not shapes:
        print(f"kernel_turns: --only names no kernel of {sorted({kernel_of(s[0]) for s in SHAPES})}",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    trees = {"this": os.path.dirname(os.path.abspath(__file__)),
             "other": os.path.abspath(args.other)}
    result = {"card": card, "shapes": {name: {"other": [], "this": [], "library": [],
                                              "split": {}} for name in shapes}}
    digests: dict = {}
    for turn in ORDER:
        env = {**os.environ, "PYTHONPATH": trees[turn]}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               "--only", args.only], cwd=trees[turn], env=env,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        lines = proc.stdout.strip().splitlines()
        times = json.loads(lines[-1])
        if not lines[0].startswith(trees[turn]):
            print(f"the {turn} turn imported the port from {lines[0]}", file=sys.stderr)
            return 1
        for name in shapes:
            r = result["shapes"][name]
            r[turn].append(times[name]["ms"])
            if times[name]["library"] is not None:
                r["library"].append(times[name]["library"])
            for extra in ("library_dbias", "library_sdpa"):
                if extra in times[name]:
                    r.setdefault(extra, []).append(times[name][extra])
            if "apart" in times[name]:
                r.setdefault("apart", {}).setdefault(turn, times[name]["apart"])
            if times[name]["split"] is not None:
                r["split"].setdefault(turn, times[name]["split"])
            for part, hexd in times[name]["digests"].items():
                digests.setdefault(name, {}).setdefault(part, {}).setdefault(turn, set()).add(hexd)
        print(f"{turn:5s} " + "  ".join(
            f"{k}: {v['ms']:.4f} ms" + (f" (library {v['library']:.4f})" if v["library"] else "")
            for k, v in times.items()), flush=True)
    for name, kind, b, tokens, c, _ in SHAPES:
        if name in result["shapes"] and bound_ms(kind, b, tokens, c) is not None:
            result["shapes"][name]["bound"] = bound_ms(kind, b, tokens, c)
    for name, t in result["shapes"].items():
        t["same_bits"] = {part: len(d["this"]) == 1 and d["this"] == d["other"]
                          for part, d in digests[name].items()}
        print(f"{name}: bits " + ", ".join(f"{part} {'the same' if same else 'different'}"
                                           for part, same in t["same_bits"].items())
              + " in both checkouts")
        print(f"{name}: other {min(t['other']):.4f} ms, this {min(t['this']):.4f} ms "
              f"(this / other {min(t['this']) / min(t['other']):.3f})"
              + (f"; library {min(t['library']):.4f}-{max(t['library']):.4f} ms (this / best "
                 f"library {min(t['this']) / min(t['library']):.3f})" if t["library"] else "")
              + (f"; library with dbias {min(t['library_dbias']):.4f}-"
                 f"{max(t['library_dbias']):.4f} ms" if "library_dbias" in t else "")
              + (f"; LN+linear+SDPA+linear {min(t['library_sdpa']):.4f}-"
                 f"{max(t['library_sdpa']):.4f} ms" if "library_sdpa" in t else "")
              + (f"; bound {t['bound']:.4f} ms (this at {100 * t['bound'] / min(t['this']):.1f} "
                 "% of it)" if "bound" in t else ""))
        for turn, apart in t.get("apart", {}).items():
            print(f"{name}: {turn} err/tol against its plain version (TOL_NS_BF16, printed, not "
                  "enforced): " + ", ".join(f"{k} {v:.3f}" for k, v in apart.items()))
        for turn, split in t["split"].items():
            print(f"{name}: {turn} launches a call: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(split.items(),
                                                                   key=lambda kv: -kv[1])))
    padded = [name for name in result["shapes"] if name.endswith(" padded")]
    if len(padded) == 2 * len(SWINL1280):  # both shifts of every stage: one forward's sum
        forward = {side: sum(SWINL1280_BLOCKS[int(name.split(",")[1])] // 2
                             * min(result["shapes"][name][side]) for name in padded)
                   for side in ("other", "this", "library")}
        result["swinL1280_forward_ms"] = forward
        print(f"1 Swin-Large/1280 a forward at batch 64, 24 launches: other "
              f"{forward['other']:.4f} ms, this {forward['this']:.4f} ms; SDPA on the same "
              f"windows {forward['library']:.4f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
