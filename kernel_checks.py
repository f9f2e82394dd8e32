"""Each hand-written kernel's card check at one call, and the calls to check.

One function per kernel wrapper (``check_<wrapper>``; 5′ and 5″ share one)
holds the kernel against its plain version on the same inputs, within the
kernel's one tolerance (the ``TOL_*`` constants below, each beside its
reason), rejects a control (the same comparison with a fault planted in the
kernel's result or in the plain version's inputs), and asserts one launch a
call and the same bits twice.  It returns ``(kernel, plain)``, the two calls
on those inputs, for timing.  Its case lists name the calls it is held at:
small shapes, the edges of its tiles and the main paths' own calls (batch 64
serving, 128 views training).

``tests/test_torch_cuda.py`` runs every check at every case, in fp32 and
bf16; ``chip_smoke.py`` runs each wrapper's ``MAIN_PATH`` cases in bf16 and
times them.  Needs a GPU to run; importing it needs none.
"""

from __future__ import annotations

import torch

from ego_moment_cle_vit_tpu_torch.kernels import attn_half as tah
from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as tfa
from ego_moment_cle_vit_tpu_torch.kernels import gpf as tgpf
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as tns
from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as tpa
from ego_moment_cle_vit_tpu_torch.kernels import subspace_isqrt as tsi
from ego_moment_cle_vit_tpu_torch.kernels import swiglu_norm as tsn
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as twa
from ego_moment_cle_vit_tpu_torch.models.swin import _attn_mask, _relative_position_index
from ego_moment_cle_vit_tpu_torch.ops.graph import (
    gpf_fuse,
    normalize_graph,
    token_similarity_graph,
)
from ego_moment_cle_vit_tpu_torch.ops.moments import graph_weighted_mean, isqrt_cov_subspace

WS = 7
PLAIN_IMAGES = 8  # images a plain version takes at once at the main paths' batches
PADDED = {322: 320, 161: 160, 84: 80, 42: 40}  # Swin-Large/1280's padded canvases: real rows

# Tolerances, each kernel against its plain version, by dtype where it takes
# both.  Attention outputs (kernels 1, 3) per element, |err| <= atol + rtol
# |ref|: fp32 by sum order; bf16 by P rounded to bf16 before P v plus one ulp
# (2^-7 |y|) of the output's rounding.  An H100 reads up to 0.75 of it.
TOL_ATTENTION = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0**-7)}
# their backwards (1b, 3b): dqkv as above, both sides rounding P and ds to the
# input type, so that in bf16 a rounding landing on the other side moves two
# ulps of the output; dbias, a sum over every (image, window), within btol of
# its own largest entry: (atol, rtol, btol)
TOL_ATTENTION_BWD = {torch.float32: (1e-4, 1e-4, 1e-3), torch.bfloat16: (2e-2, 2.0**-6, 2e-2)}
# q-tiled attention (6): bf16 one ulp of the output's rounding over a
# pre-rounding difference far under atol (the kernel rounds the unnormalized
# probabilities of its online softmax, the plain version the normalized ones);
# atol stays under a 785-token output's typical size (~0.06), so that the
# padded-keys control fails.  Its backward (6b): ds rounded on both sides,
# then the output, two ulps.
TOL_TILED = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-3, 2.0**-7)}
TOL_TILED_BWD = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (4e-3, 2.0**-6)}
TOL_LSE = 1e-4  # the log-sum-exp of 3 and 6, of the largest plain one
# GPF (2): each entry within TOL_GPF of ``gpf_error_scale``, which holds it at
# its own size
TOL_GPF = 2e-4
# 2b: the token gradients within tol of each row's largest entry (an H100 at
# the main paths' [64, N, D]: up to 0.78 of the bf16 one), dc within
# TOL_GPF_DC of its largest.  The cotangent is zeroed where the fused graph
# before its clamp lies within KINK_BAND of its error scale of zero: on the
# clamp's kink the two sides, summed in other orders, may take other branches.
TOL_GPF_BWD = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
TOL_GPF_DC = 1e-3
KINK_BAND = 1e-4
# Newton-Schulz (5, fp32 inside), |err| <= rtol |ref| + atol max |ref|: fp32 M
# by sum order over 14 chained products, bf16 M one ulp of the output's
# rounding: (rtol, atol)
TOL_NS = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0**-7, 1e-4)}
# 5′ and 5″ (bf16 storage, fp32 sums) against plain versions that round where
# they round, M in either type, (rtol, atol) as above: an fp32 sum taken in
# another order lands on the other side of a bf16 rounding now and then, and
# the later steps carry that ulp at the size of the entries.  On a full-rank M
# (z^T z) atol 1e-4; on the moment head's M (rank <= 16, from a rank-16 graph)
# that carry weighs more beside its largest entry (an H100: 1.08 of 1e-4 for
# fp32 M at [64, 1024, 1024]; four iterations 42x), 5e-4.
TOL_NS_BF16 = {"full_rank": (2.0**-7, 1e-4), "head": (2.0**-7, 5e-4)}
# the fused attention half (4), per element: both sides round xn, qkv, P and
# om; an fp32 sum landing on the other side of a rounding moves an ulp through
# the proj product, then y rounds: (atol, rtol).  Its backward (4b): dx as the
# forward, every parameter gradient within gtol of its own largest entry (sums
# over 10^5 tokens of rounded products): (atol, rtol, gtol)
TOL_AH = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2.0**-6)}
TOL_AH_BWD = {torch.float32: (1e-4, 1e-4, 1e-3), torch.bfloat16: (3e-2, 2.0**-6, 2e-2)}
# kernel 7: its error against the fp64 witness, ||out - witness|| over
# ||witness - a_k I / sqrt(t)||, at most this many times the plain fp32
# route's (an H100, k = 5: 0.96-1.36x on sound runs, 3.7-20x with the lo terms
# dropped)
TOL_SI_F32_RATIO = 2.0
# bf16 outputs against the plain route's: per element |err| <= 2^-7 |plain| +
# 1e-4 max |plain|, and at most 3.5e-4 of the elements apart (an H100 at k =
# 5: 1.1e-4 to 1.8e-4 on sound runs, 6.9e-4 to 5.1e-3 with the lo terms
# dropped; 1.5e-5 to 6.5e-5 at k = 3)
TOL_SI_BF16 = (2.0**-7, 1e-4, 3.5e-4)
# kernel 8, per element of the true columns, |err| <= 2^-7 |plain| + 2^-12 max
# |row|: one bf16 ulp of the output's rounding, over fp32 statistics and affine
# summed in another order (a few fp32 ulps of the row's scale)
TOL_SWIGLU = (2.0**-7, 2.0**-12)


def close(out, ref, atol, rtol):
    return bool(((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())


def in_slices(fn, sliced, *rest, images=PLAIN_IMAGES):
    """``fn`` over ``images`` images of each tensor of ``sliced`` at a time,
    with ``rest``; its results concatenated: a plain version at a main path's
    batch, whose fp32 work does not fit the card whole."""
    parts = [fn(*(t[i:i + images] for t in sliced), *rest)
             for i in range(0, sliced[0].shape[0], images)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def window_bias(g, device, heads):
    """A Swin block's relative-position bias [H, 49, 49], its table at std 1
    (as trained tables reach; at init, 0.02, the bias would be invisible)."""
    table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=device)
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=device)
    return table[idx].reshape(WS * WS, WS * WS, heads).permute(2, 0, 1).contiguous()


# Kernel 1 (bf16 on the Hopper forward, fp32 its CUDA-core body) at the edges
# of its geometry: windows of 2, 4, 7 and 8, batches of 1, 5 and 64 (image
# chunks of one image, a ragged last chunk, many images a block), the four
# Swin-Base stages, and Swin-Large/1280 stage 0's padded canvas (322 = 46
# windows of 7, C = 192, 6 heads) with the pad sentinel in its masks; then the
# serving calls at batch 64, Swin-Base/224's stages 0 and 1 and every
# Swin-Large/1280 stage on its padded canvas: (B, Hp, C, heads, ws)
WA_FWD = [(1, 56, 128, 4, 7), (5, 28, 256, 8, 7), (64, 14, 512, 16, 7), (64, 7, 1024, 32, 7),
          (2, 322, 192, 6, 7), (64, 16, 128, 4, 4), (5, 24, 64, 2, 8), (1, 8, 96, 3, 8),
          (5, 6, 64, 2, 2), (64, 56, 128, 4, 7), (64, 28, 256, 8, 7),
          (64, 322, 192, 6, 7), (64, 161, 384, 12, 7), (64, 84, 768, 24, 7),
          (64, 42, 1536, 48, 7)]


def check_window_attention_fwd(device, dtype, b, hp, c, heads, ws, shifted):
    """Kernel 1 within TOL_ATTENTION of its plain version (on PLAIN_IMAGES
    images at a time), one launch a call, the same bits twice.  Windows of 7
    take Swin's tables and masks (a padded canvas a mask even unshifted,
    ``mask=None`` otherwise); other windows random tables and masks.
    Controls, on the first images: the bias omitted, the mask dropped, and
    on a padded canvas the pad sentinel removed (real queries then attend
    the pad tokens' keys)."""
    atol, rtol = TOL_ATTENTION[dtype]
    g = torch.Generator(device=device).manual_seed(hp * 131 + ws * 7 + b)
    nt, nw = ws * ws, (hp // ws) ** 2
    qkv = torch.randn(b, hp, hp, 3 * c, generator=g, device=device).to(dtype)
    h = PADDED.get(hp, hp)
    shift = 3 if shifted and hp > WS else 0
    if ws == WS:
        bias = window_bias(g, device, heads)
        mask = (torch.as_tensor(_attn_mask(h, h, hp, hp, WS, shift), device=device)
                if shift or h != hp else None)
    else:
        bias = torch.randn(heads, nt, nt, generator=g, device=device)
        mask = (torch.randn(nw, nt, nt, generator=g, device=device) * 3 if shifted else None)
    rest = (heads, ws, (c // heads) ** -0.5)
    before = twa.window_attention_fwd.launches
    out = twa.window_attention_fwd(qkv, bias, mask, *rest)
    assert twa.window_attention_fwd.launches == before + 1
    ref = in_slices(twa.window_attention_plain, (qkv,), bias, mask, *rest)
    assert out.dtype == dtype and close(out, ref, atol, rtol)
    controls = [(torch.zeros_like(bias), mask)]
    if mask is not None:
        controls.append((bias, None))
    if h != hp:
        no_pad = _attn_mask(hp, hp, hp, hp, WS, shift)
        controls.append((bias, None if no_pad is None else torch.as_tensor(no_pad,
                                                                           device=device)))
    first, ref_first = qkv[:PLAIN_IMAGES], ref[:PLAIN_IMAGES]
    for ctrl_bias, ctrl_mask in controls:
        ctrl = twa.window_attention_plain(first, ctrl_bias, ctrl_mask, *rest)
        assert not close(ctrl, ref_first, atol, rtol)
    assert torch.equal(twa.window_attention_fwd(qkv, bias, mask, *rest), out)
    return (lambda: twa.window_attention_fwd(qkv, bias, mask, *rest),
            lambda: in_slices(twa.window_attention_plain, (qkv,), bias, mask, *rest))


# Kernel 1b on its Hopper kernel: the four Swin-Base stage geometries at a
# small batch and at the training call's 128 views, a padded Swin-Large canvas
# (84 = 12 windows of 7, the pad sentinel in the mask), and windows of 4 and 8
# with tables and masks drawn at random: (B, Hp, C, heads, ws)
WA_BWD = [(3, 56, 128, 4, 7), (4, 28, 256, 8, 7), (5, 14, 512, 16, 7), (6, 7, 1024, 32, 7),
          (2, 84, 576, 18, 7), (3, 16, 128, 4, 4), (2, 24, 64, 2, 8), (9, 8, 96, 3, 8),
          (128, 56, 128, 4, 7), (128, 28, 256, 8, 7), (128, 14, 512, 16, 7),
          (128, 7, 1024, 32, 7)]


def check_window_attention_bwd(device, dtype, b, hp, c, heads, ws, shifted):
    """1b within TOL_ATTENTION_BWD of its plain version, one launch a call,
    the same bits twice; dK zeroed and dbias dropped fall outside."""
    atol, rtol, btol = TOL_ATTENTION_BWD[dtype]
    g = torch.Generator(device=device).manual_seed(hp * 131 + ws)
    nt, nw = ws * ws, (hp // ws) ** 2
    qkv = torch.randn(b, hp, hp, 3 * c, generator=g, device=device).to(dtype)
    dout = torch.randn(b, hp, hp, c, generator=g, device=device).to(dtype)
    if ws == WS:
        bias = window_bias(g, device, heads)
        h = PADDED.get(hp, hp)
        mask = (torch.as_tensor(_attn_mask(h, h, hp, hp, WS, 3 if shifted else 0),
                                device=device) if shifted or h != hp else None)
    else:
        bias = torch.randn(heads, nt, nt, generator=g, device=device)
        mask = (torch.randn(nw, nt, nt, generator=g, device=device) * 3 if shifted else None)
    args = (qkv, bias, mask, dout, heads, ws, (c // heads) ** -0.5)
    before = twa.window_attention_bwd.launches
    dqkv, dbias = twa.window_attention_bwd(*args)
    assert twa.window_attention_bwd.launches == before + 1
    ref_dqkv, ref_dbias = twa.window_attention_bwd_plain(*args)
    assert close(dqkv, ref_dqkv, atol, rtol)
    assert (dbias - ref_dbias).abs().max().item() <= btol * ref_dbias.abs().max().item()
    again = twa.window_attention_bwd(*args)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)
    ctrl = ref_dqkv.clone()
    ctrl[..., c:2 * c] = 0
    assert not close(ctrl, ref_dqkv, atol, rtol)
    assert ref_dbias.abs().max().item() > btol * ref_dbias.abs().max().item()
    return (lambda: twa.window_attention_bwd(*args),
            lambda: twa.window_attention_bwd_plain(*args))


# (B, N, D): the Swin, ViT/224, ViT/448 and Swin-Large/1280 token counts at a
# small batch, and the serving calls at batch 64 of Swin-Base/224, ViT-Base at
# 224 and 448, ViT-Large/512 and EVA-02-L/448 (N = D = 1024) and
# Swin-Large/1280
GPF = [(4, 49, 256), (4, 196, 192), (4, 784, 40), (4, 1600, 48), (64, 49, 1024),
       (64, 196, 768), (64, 784, 768), (64, 1024, 1024), (64, 1600, 1536)]


def check_gpf_fwd(device, dtype, similarity, b, n, d):
    """Kernel 2 with one tensor twice and with two: each entry within TOL_GPF
    of ``gpf_error_scale``; the off-diagonal entries zeroed fall outside."""
    g = torch.Generator(device=device).manual_seed(0)
    ta = torch.randn(b, n, d, generator=g, device=device).to(dtype)
    tp = torch.randn(b, n, d, generator=g, device=device).to(dtype)
    c = torch.rand(3, 3, generator=g, device=device)
    for pos in (ta, tp):
        before = tgpf.gpf_fwd.launches
        out = tgpf.gpf_fwd(ta, pos, c, similarity)
        assert tgpf.gpf_fwd.launches == before + 1
        ref = tgpf.gpf_plain(ta, pos, c, similarity)
        scale = tgpf.gpf_error_scale(ta, pos, c, similarity)
        assert out.dtype == torch.float32
        assert ((out - ref).abs() <= TOL_GPF * scale).all()
        zeroed = out * torch.eye(n, device=device)
        assert not ((zeroed - ref).abs() <= TOL_GPF * scale).all()
    # serving's call: one tensor twice
    return (lambda: tgpf.gpf_fwd(ta, ta, c, similarity),
            lambda: tgpf.gpf_plain(ta, ta, c, similarity))


def off_the_kink(ta, tp, c, cot, similarity):
    """``cot`` zeroed where the fused graph before its clamp lies within
    KINK_BAND of its error scale of zero (see TOL_GPF_BWD)."""
    pre = gpf_fuse(token_similarity_graph(ta, similarity, 1e-6),
                   token_similarity_graph(tp, similarity, 1e-6), c, symmetric_enforce=True,
                   clamp=False)
    band = KINK_BAND * tgpf.gpf_error_scale(ta, tp, c, similarity, 1e-6, True)
    return torch.where(pre.abs() <= band, torch.zeros_like(cot), cot)


# (B, N, D): small shapes, and the training calls (two views of [64, N, D]) of
# the Swin-Base/224, ViT-Base/224 and /448, ViT-Large/512 and Swin-Large/1280
# paths
GPF_BWD = [(4, 49, 256), (3, 16, 100), (2, 196, 192), (1, 784, 64), (64, 49, 1024),
           (64, 196, 768), (64, 784, 768), (64, 1024, 1024), (64, 1600, 1536)]


def check_gpf_bwd(device, dtype, similarity, b, n, d):
    """2b against its plain version within TOL_GPF_BWD / TOL_GPF_DC, two
    token sets and one tensor twice; controls: half of dX, dc zeroed.  One
    tensor as both token sets through autograd gets the two gradients' sum,
    for which either alone does not pass."""
    tol = TOL_GPF_BWD[dtype]
    g = torch.Generator(device=device).manual_seed(2)
    ta = torch.randn(b, n, d, generator=g, device=device).to(dtype)
    tp = torch.randn(b, n, d, generator=g, device=device).to(dtype)
    c = torch.rand(3, 3, generator=g, device=device) + 0.05
    cot = torch.randn(b, n, n, generator=g, device=device)

    def rows_close(out, ref):
        scale = ref.float().abs().amax(dim=-1, keepdim=True)
        return bool(((out.float() - ref.float()).abs() <= tol * scale).all())

    for pos in (tp, ta):
        cot_pos = off_the_kink(ta, pos, c, cot, similarity)
        before = tgpf.gpf_bwd.launches
        dta, dtp, dc = tgpf.gpf_bwd(ta, pos, c, cot_pos, similarity)
        assert tgpf.gpf_bwd.launches == before + 1
        rta, rtp, rdc = tgpf.gpf_bwd_plain(ta, pos, c, cot_pos, similarity)
        assert dta.dtype == dtype and dc.dtype == torch.float32 and dc.shape == (b, 3, 3)
        assert rows_close(dta, rta) and rows_close(dtp, rtp)
        assert ((dc - rdc).abs() <= TOL_GPF_DC * rdc.abs().amax()).all()
        # controls: the dR^T half of dX dropped (half the gradient), dc zeroed
        assert not rows_close(0.5 * rta.float(), rta)
        assert not ((torch.zeros_like(rdc) - rdc).abs() <= TOL_GPF_DC * rdc.abs().amax()).all()
    # one tensor as both token sets: autograd adds the two gradients
    cot_same = off_the_kink(ta, ta, c, cot, similarity)
    x = ta.clone().requires_grad_()
    tgpf.gpf(x, x, c, similarity).backward(cot_same)
    rta, rtp, _ = tgpf.gpf_bwd_plain(ta, ta, c, cot_same, similarity)
    total = rta.float() + rtp.float()
    assert rows_close(x.grad, total)
    assert not rows_close(rta, total)  # a control: one gradient alone
    # training's call: two views
    cot_two = off_the_kink(ta, tp, c, cot, similarity)
    return (lambda: tgpf.gpf_bwd(ta, tp, c, cot_two, similarity),
            lambda: tgpf.gpf_bwd_plain(ta, tp, c, cot_two, similarity))


# (B, W, T, C, heads, bias heads or None, mask groups or None): the ViT call at
# two widths, a Swin packed shape with everything switched on, shared bias and
# mask, and the longest group the wrappers admit; then the main path's calls:
# ViT-Base/224 and ViT-Tiny (three heads) served at batch 64 and trained at
# 128 views, and the Swin packed shape (two windows of 49 a group at stage 0)
# at 64
PACKED = [(3, 1, 197, 768, 12, None, None), (2, 1, 197, 192, 3, None, None),
          (3, 4, 98, 128, 4, 4, 4), (2, 3, 50, 128, 2, 1, 1), (2, 1, 256, 64, 2, 2, None),
          *((b, 1, 197, c, heads, None, None) for b in (64, 128) for c, heads in ((768, 12),
                                                                                 (192, 3))),
          (64, 32, 98, 128, 4, 4, 32)]


def packed_inputs(device, dtype, b, w, t, c, heads, hb, wm):
    g = torch.Generator(device=device).manual_seed(3)
    qkv = torch.randn(b, w, t, 3 * c, generator=g, device=device).to(dtype)
    dout = torch.randn(b, w, t, c, generator=g, device=device).to(dtype)
    bias = torch.randn(hb, t, t, generator=g, device=device) if hb else None
    mask = (torch.where(torch.rand(wm, t, t, generator=g, device=device) < 0.2, -100.0, 0.0)
            if wm else None)
    return qkv, dout, bias, mask


def check_packed_attention_fwd(device, dtype, b, w, t, c, heads, hb, wm):
    """Kernel 3 within TOL_ATTENTION, its lse within TOL_LSE, the same bits
    twice.  Controls: the padded keys left unmasked (zero keys join the
    softmax), and the bias dropped."""
    atol, rtol = TOL_ATTENTION[dtype]
    qkv, _, bias, mask = packed_inputs(device, dtype, b, w, t, c, heads, hb, wm)
    before = tpa.packed_attention_fwd.launches
    out = tpa.packed_attention_fwd(qkv, bias, mask, heads)
    assert tpa.packed_attention_fwd.launches == before + 1
    ref, ref_lse = tpa.packed_attention_plain(qkv, bias, mask, heads, return_lse=True)
    assert out.dtype == dtype and out.shape == (b, w, t, c)
    assert close(out, ref, atol, rtol)
    # the log-sum-exp the training forward asks for, and the same output with it
    out_lse, lse = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=True)
    assert torch.equal(out_lse, out) and lse.shape == (b * w, heads, t)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE * ref_lse.abs().max().item()
    again, lse_again = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=True)
    assert torch.equal(again, out) and torch.equal(lse_again, lse)  # bit for bit
    pad = -(-t // 64) * 64 - t
    if pad:
        padded = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
        pb = None if bias is None else torch.nn.functional.pad(bias, (0, pad, 0, pad))
        pm = None if mask is None else torch.nn.functional.pad(mask, (0, pad, 0, pad))
        ctrl = tpa.packed_attention_plain(padded, pb, pm, heads)[:, :, :t]
        assert not close(ctrl, ref, atol, rtol)
    if bias is not None:
        assert not close(tpa.packed_attention_plain(qkv, None, mask, heads), ref, atol, rtol)
    return (lambda: tpa.packed_attention_fwd(qkv, bias, mask, heads),
            lambda: tpa.packed_attention_plain(qkv, bias, mask, heads))


def check_packed_attention_bwd(device, dtype, b, w, t, c, heads, hb, wm):
    """3b within TOL_ATTENTION_BWD, the same bits twice, the Function through
    the same kernels; controls: dK zeroed, the bias gradient dropped."""
    atol, rtol, btol = TOL_ATTENTION_BWD[dtype]
    qkv, dout, bias, mask = packed_inputs(device, dtype, b, w, t, c, heads, hb, wm)
    out, lse = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=True)
    before = tpa.packed_attention_bwd.launches
    dqkv, dbias = tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads)
    assert tpa.packed_attention_bwd.launches == before + 1
    ref_dqkv, ref_dbias = tpa.packed_attention_bwd_plain(qkv, bias, mask, out, lse, dout, heads)
    assert dqkv.dtype == dtype and close(dqkv, ref_dqkv, atol, rtol)
    ctrl = ref_dqkv.clone()
    ctrl[..., c:2 * c] = 0  # a control: dK zeroed falls outside
    assert not close(ctrl, ref_dqkv, atol, rtol)
    if bias is None:
        assert dbias is None
    else:
        assert dbias.dtype == torch.float32 and dbias.shape == bias.shape
        top = ref_dbias.abs().max().item()
        assert (dbias - ref_dbias).abs().max().item() <= btol * top
        assert top > btol * top  # a control: the bias gradient dropped falls outside
        assert tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads,
                                        need_dbias=False)[1] is None
    # the same gradient twice, bit for bit
    again, dbias_again = tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads)
    assert torch.equal(again, dqkv)
    assert dbias is None or torch.equal(dbias_again, dbias)
    # and the Function routes autograd through the same kernels
    q2 = qkv.clone().requires_grad_()
    b2 = None if bias is None else bias.clone().requires_grad_()
    tpa.packed_attention(q2, b2, mask, heads).backward(dout)
    assert torch.equal(q2.grad, dqkv) and (b2 is None or torch.equal(b2.grad, dbias))
    return (lambda: tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads),
            lambda: tpa.packed_attention_bwd_plain(qkv, bias, mask, out, lse, dout, heads))


# (B, T, C, heads): the ViT-Base call at 448, two heads of 64 and of 32 past
# the packed kernel's 256 tokens, a sequence under one query block, one tile;
# then the main paths' calls, ViT-Base/448 (12 heads) and ViT-Large/512 and
# EVA-02-L/448 (1025 tokens, 16 heads), served at batch 64 and trained at 128
# views
FLASH = [(2, 785, 768, 12), (2, 300, 128, 2), (3, 325, 64, 2), (2, 100, 64, 2), (2, 64, 128, 4),
         (64, 785, 768, 12), (128, 785, 768, 12), (64, 1025, 1024, 16), (128, 1025, 1024, 16)]


def check_flash_attention_tiled_fwd(device, dtype, b, t, c, heads):
    """Kernel 6 within TOL_TILED of its plain version (on PLAIN_IMAGES images
    at a time), its lse within TOL_LSE, the same bits twice.  Controls: the
    keys padded to the kernel's tile and left unmasked, and every query
    attending the first tile of keys only (as if the walk over the key tiles
    stopped after one), on the first images."""
    atol, rtol = TOL_TILED[dtype]
    g = torch.Generator(device=device).manual_seed(4)
    qkv = torch.randn(b, t, 3 * c, generator=g, device=device).to(dtype)
    before = tfa.flash_attention_tiled_fwd.launches
    out, lse = tfa.flash_attention_tiled_fwd(qkv, heads)
    assert tfa.flash_attention_tiled_fwd.launches == before + 1
    ref, ref_lse = in_slices(tfa.flash_attention_tiled_plain, (qkv,), heads)
    assert out.dtype == dtype and out.shape == (b, t, c) and lse.shape == (b, heads, t)
    assert close(out, ref, atol, rtol)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE * ref_lse.abs().max().item()
    again, lse_again = tfa.flash_attention_tiled_fwd(qkv, heads)
    assert torch.equal(again, out) and torch.equal(lse_again, lse)
    first, ref_first = qkv[:PLAIN_IMAGES], ref[:PLAIN_IMAGES]
    pad = -(-t // tfa.TILE) * tfa.TILE - t
    if pad:
        padded = torch.nn.functional.pad(first, (0, 0, 0, pad))
        assert not close(tfa.flash_attention_tiled_plain(padded, heads)[0][:, :t], ref_first,
                         atol, rtol)
    if t > tfa.TILE:
        hide = torch.zeros(1, t, t, device=device)
        hide[..., tfa.TILE:] = -100.0
        only_first = tpa.packed_attention_plain(first[:, None], None, hide, heads)[:, 0]
        assert not close(only_first, ref_first, atol, rtol)
    return (lambda: tfa.flash_attention_tiled_fwd(qkv, heads),
            lambda: in_slices(tfa.flash_attention_tiled_plain, (qkv,), heads))


def check_flash_attention_tiled_bwd(device, dtype, b, t, c, heads):
    """6b within TOL_TILED_BWD of its plain version (on PLAIN_IMAGES images
    at a time), the same bits twice, the Function through the same kernels;
    a control: dK zeroed."""
    atol, rtol = TOL_TILED_BWD[dtype]
    g = torch.Generator(device=device).manual_seed(5)
    qkv = torch.randn(b, t, 3 * c, generator=g, device=device).to(dtype)
    dout = torch.randn(b, t, c, generator=g, device=device).to(dtype)
    out, lse = tfa.flash_attention_tiled_fwd(qkv, heads)
    before = tfa.flash_attention_tiled_bwd.launches
    dqkv = tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, heads)
    assert tfa.flash_attention_tiled_bwd.launches == before + 1
    ref = in_slices(tfa.flash_attention_tiled_bwd_plain, (qkv, dout), heads)
    assert dqkv.dtype == dtype and close(dqkv, ref, atol, rtol)
    ctrl = ref.clone()
    ctrl[..., c:2 * c] = 0  # a control: dK zeroed falls outside
    assert not close(ctrl, ref, atol, rtol)
    # the same gradient twice, bit for bit
    assert torch.equal(tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, heads), dqkv)
    # and the Function routes autograd through the same kernels
    q2 = qkv.clone().requires_grad_()
    tfa.flash_attention_tiled(q2, heads).backward(dout)
    assert torch.equal(q2.grad, dqkv)
    return (lambda: tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, heads),
            lambda: in_slices(tfa.flash_attention_tiled_bwd_plain, (qkv, dout), heads))


def head_moment(g, b, n, d):
    """M2 = Zc^T W Zc in fp32 as the moment head forms it on the dense route,
    from random [b, n, d] tokens and a random non-negative symmetric graph of
    rank 16 (a Gram of non-negative features, so W and M2 are PSD as the
    head's are)."""
    tokens = torch.randn(b, n, d, generator=g, device=g.device)
    feats = torch.rand(b, n, 16, generator=g, device=g.device)
    w = normalize_graph(torch.matmul(feats, feats.transpose(1, 2)), "symmetric", eps=1e-5)
    centered = tokens - graph_weighted_mean(tokens, w, eps=1e-5)[:, None, :]
    return torch.matmul(centered.transpose(1, 2), torch.matmul(w, centered))


def ns_close(out, ref, rtol, atol):
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= rtol * ref.abs() + atol * ref.abs().max()).all())


# (B, N, D): M = z^T z / D from D + 16 rows of z (N None), and the moment
# head's M at its calls at batch 64, ViT-Base/448 (N = 784, D = 768) and a
# ViT-Tiny's (196, 192)
NS = [(4, None, 768), (2, None, 192), (2, None, 100), (3, None, 64), (64, 784, 768),
      (64, 196, 192)]


def check_newton_schulz_isqrt_fp32_fwd(device, dtype, b, n, d):
    """Kernel 5 through the width dispatch within TOL_NS of its plain
    version; four iterations fail that; the Function runs the kernel forward
    and the plain iteration's gradient."""
    rtol, atol = TOL_NS[dtype]
    g = torch.Generator(device=device).manual_seed(6)
    if n is None:
        z = torch.randn(b, d + 16, d, generator=g, device=device)
        m = (z.transpose(1, 2) @ z / d).to(dtype)
    else:
        m = head_moment(g, b, n, d).to(dtype)
    before = tns.newton_schulz_isqrt_fp32_fwd.launches
    out = tns.newton_schulz_isqrt_fwd(m, 5, 1e-5)  # the dispatch: the fp32 kernel at D <= 825
    assert tns.newton_schulz_isqrt_fp32_fwd.launches == before + 1
    ref = tns.newton_schulz_isqrt_plain(m, 5, 1e-5)
    assert out.dtype == dtype and ns_close(out, ref, rtol, atol)
    assert not ns_close(tns.newton_schulz_isqrt_plain(m, 4, 1e-5), ref, rtol, atol)  # a control
    # the Function: the kernel's forward, the plain iteration's gradient
    x = m.clone().requires_grad_()
    y = tns.newton_schulz_isqrt_kernel(x, 5, 1e-5)
    assert torch.equal(y, out)
    y.float().square().sum().backward()
    x_ref = m.clone().requires_grad_()
    tns.newton_schulz_isqrt_plain(x_ref, 5, 1e-5).float().square().sum().backward()
    assert torch.isfinite(x.grad).all()
    torch.testing.assert_close(x.grad.float(), x_ref.grad.float(), rtol=1e-2, atol=1e-2 * float(
        x_ref.grad.float().abs().max()))
    return (lambda: tns.newton_schulz_isqrt_fp32_fwd(m, 5, 1e-5),
            lambda: tns.newton_schulz_isqrt_plain(m, 5, 1e-5))


# (variant, B, N, D): M = z^T z (N None) at the two model widths, a width the
# bf16 kernels pad (900 -> 1024) and the streamed grouping at its TPU grid's
# smallest width; the moment head's M at its calls at batch 64, ViT-Large/512
# and EVA-02-L/448 (N = D = 1024) and Swin-Large/1280 (N = 1600, D = 1536)
NS_BF16 = [("bf16", 2, None, 1024), ("bf16_streamed", 1, None, 1536), ("bf16", 2, None, 900),
           ("bf16_streamed", 2, None, 512), ("bf16", 64, 1024, 1024),
           ("bf16_streamed", 64, 1600, 1536)]


def check_newton_schulz_bf16(device, dtype, variant, b, n, d):
    """Kernels 5′ / 5″ against their plain versions, which round at the same
    points, within TOL_NS_BF16; four iterations fail that; two runs give the
    same bits, and one step (Mn and an elementwise update) the plain
    version's, or the two do not normalize alike."""
    g = torch.Generator(device=device).manual_seed(8)
    if n is None:
        z = torch.randn(b, d + 64, d, generator=g, device=device)
        m = (z.transpose(1, 2) @ z / (d + 64)).to(dtype)
    else:
        m = head_moment(g, b, n, d).to(dtype)
    rtol, atol = TOL_NS_BF16["full_rank" if n is None else "head"]
    fwd, plain = {
        "bf16": (tns.newton_schulz_isqrt_bf16_fwd, tns.newton_schulz_isqrt_bf16_plain),
        "bf16_streamed": (tns.newton_schulz_isqrt_bf16_streamed_fwd,
                          tns.newton_schulz_isqrt_bf16_streamed_plain),
    }[variant]
    before = fwd.launches
    out = fwd(m, 5, 1e-5)
    assert fwd.launches == before + 1
    ref = plain(m, 5, 1e-5)
    assert out.dtype == dtype and out.shape == m.shape and ns_close(out, ref, rtol, atol)
    assert torch.equal(fwd(m, 5, 1e-5), out)
    assert not ns_close(plain(m, 4, 1e-5), ref, rtol, atol)  # a control
    assert ns_close(fwd(m, 0, 1e-5), plain(m, 0, 1e-5), rtol, atol)  # I / sqrt(tr), no product
    if tns.variant_for(d) == variant:
        # the dispatch picks this kernel, and the Function differentiates the
        # plain fp32 iteration
        x = m.clone().requires_grad_()
        y = tns.newton_schulz_isqrt_kernel(x, 5, 1e-5)
        assert torch.equal(y, out) and fwd.launches == before + 4
        cot = torch.randn(m.shape, generator=g, device=device).to(dtype)
        y.backward(cot)
        x_ref = m.clone().requires_grad_()
        tns.newton_schulz_isqrt_plain(x_ref, 5, 1e-5).backward(cot)
        assert torch.equal(x.grad, x_ref.grad)
    assert torch.equal(fwd(m, 1, 1e-5), plain(m, 1, 1e-5))
    return lambda: fwd(m, 5, 1e-5), lambda: plain(m, 5, 1e-5)


# (B, Hp, C, heads, shifted): stage 0 and stage 1 shapes of Swin-Base at a
# small batch, and a padded canvas (16 tokens pad to 21); then Swin-Base's
# stages 0 and 1 under fused_half as served (batch 64) and trained (128
# views), unshifted and shifted
ATTN_HALF = [(2, 14, 128, 4, True), (2, 7, 256, 8, False), (1, 21, 128, 4, True),
             *((b, hp, c, heads, shifted) for b in (64, 128)
               for hp, c, heads in ((56, 128, 4), (28, 256, 8)) for shifted in (False, True))]


def attn_half_inputs(device, dtype, b, hp, c, heads, shifted):
    """(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask) of one fused Swin
    block, and a cotangent dy."""
    g = torch.Generator(device=device).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    bias = window_bias(g, device, heads)
    mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, WS, 3), device=device)
            if shifted else None)
    args = (randn(b, hp, hp, c).to(dtype), 1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
            randn(3 * c, c, scale=c ** -0.5).to(dtype), randn(3 * c, scale=0.1).to(dtype),
            randn(c, c, scale=c ** -0.5).to(dtype), randn(c, scale=0.1).to(dtype), bias, mask)
    return args, randn(b, hp, hp, c).to(dtype)


def check_attn_half_fwd(device, dtype, b, hp, c, heads, shifted):
    """Kernel 4 within TOL_AH of its plain version; controls: the bias
    omitted, and the residual dropped."""
    atol, rtol = TOL_AH[dtype]
    args, _ = attn_half_inputs(device, dtype, b, hp, c, heads, shifted)
    before = tah.attn_half_fwd.launches
    out = tah.attn_half_fwd(*args, heads, WS)
    assert tah.attn_half_fwd.launches == before + 1
    ref = tah.attn_half_plain(*args, heads, WS)
    assert out.dtype == dtype and close(out, ref, atol, rtol)
    no_bias = args[:7] + (torch.zeros_like(args[7]), args[8])
    assert not close(tah.attn_half_plain(*no_bias, heads, WS), ref, atol, rtol)
    assert not close(ref.float() - args[0].float(), ref, atol, rtol)
    return (lambda: tah.attn_half_fwd(*args, heads, WS),
            lambda: tah.attn_half_plain(*args, heads, WS))


def first_chunk_qkv_gradient(args: tuple, dy: torch.Tensor, heads: int) -> torch.Tensor:
    """The first token chunk's share of dwqkv = dqkv^T xn, as 4b's
    weight-gradient kernel sums it into one partial, in plain PyTorch (xn,
    qkv, do and dqkv rounded as in the kernels)."""
    x, ln_g, ln_b, wqkv, bqkv, wproj, _, bias, mask = args
    b, hp, wp, c = x.shape
    m, dt = b * hp * wp, x.dtype
    geo = tah.bwd_geometry(b, m, c, (hp // WS) * (wp // WS), heads, dt)
    chunk = -(-m // 64 // geo["w_chunks"]) * 64
    xn = torch.nn.functional.layer_norm(x.float(), (c,), ln_g, ln_b, 1e-5).to(dt)
    qkv = (xn.float() @ wqkv.float().T + bqkv.float()).to(dt)
    dom = (dy.float() @ wproj.float()).to(dt)
    dqkv, _ = twa.window_attention_bwd_plain(qkv, bias, mask, dom, heads, WS,
                                             (c // heads) ** -0.5)
    return dqkv.reshape(m, 3 * c)[:chunk].float().T @ xn.reshape(m, c)[:chunk].float()


def check_attn_half_bwd(device, dtype, b, hp, c, heads, shifted):
    """4b within TOL_AH_BWD of its plain version, the same bits twice, the
    Function through the same kernels.  Controls: the first token chunk's
    dwqkv partial dropped, and dbias dropped."""
    atol, rtol, gtol = TOL_AH_BWD[dtype]
    args, dy = attn_half_inputs(device, dtype, b, hp, c, heads, shifted)
    before = tah.attn_half_bwd.launches
    got = tah.attn_half_bwd(*args, dy, heads, WS)
    assert tah.attn_half_bwd.launches == before + 1
    ref = tah.attn_half_bwd_plain(*args, dy, heads, WS)
    assert got[0].dtype == dtype and close(got[0], ref[0], atol, rtol)
    for a, r in zip(got[1:], ref[1:]):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert (a - r).abs().max().item() <= gtol * r.abs().max().item()
    # the same gradients twice, bit for bit
    assert all(torch.equal(a, r) for a, r in zip(tah.attn_half_bwd(*args, dy, heads, WS), got))
    share = first_chunk_qkv_gradient(args, dy, heads)
    assert share.abs().max().item() > gtol * ref[3].abs().max().item()
    assert ref[7].abs().max().item() > gtol * ref[7].abs().max().item()
    # and the Function routes autograd through the same kernels
    leaves = [t.clone().requires_grad_() for t in args[:8]]
    tah.attn_half(*leaves, args[8], heads, WS).backward(dy)
    for leaf, want in zip(leaves, got):
        assert torch.equal(leaf.grad, want.to(leaf.dtype))
    return (lambda: tah.attn_half_bwd(*args, dy, heads, WS),
            lambda: tah.attn_half_bwd_plain(*args, dy, heads, WS))


# (B, N, D) of the subspace iSQRT: ViT-L/16 at 448, Swin's last stage at batch
# 64, ViT-Base at 224, and ViT-L/16 at 448 served at batch 64
SUBSPACE = [(4, 784, 1024), (64, 49, 1024), (8, 196, 768), (64, 784, 1024)]


def subspace_inputs(g, b, n, d, dtype):
    """centered and weighted [b, n, d] as the moment head makes them: tokens
    centred on their graph-weighted mean, and a random symmetric graph,
    normalized as the head normalizes it, times them."""
    tokens = torch.randn(b, n, d, generator=g, device=g.device).to(dtype)
    graph = torch.rand(b, n, n, generator=g, device=g.device)
    w = normalize_graph(0.5 * (graph + graph.transpose(1, 2)), "symmetric", eps=1e-5)
    centered = tokens - graph_weighted_mean(tokens, w, eps=1e-5)[:, None, :]
    weighted = torch.matmul(w.float(), centered.float()).to(dtype)
    return centered.contiguous(), weighted.contiguous()


def bf16_apart(out, plain):
    """The largest |out - plain| over its per-element tolerance, and the
    share of elements that differ."""
    rtol, atol, _ = TOL_SI_BF16
    out, plain = out.float(), plain.float()
    tol = rtol * plain.abs() + atol * plain.abs().max()
    return float(((out - plain).abs() / tol).max()), float((out != plain).double().mean())


def witness_error(out, witness, centered, weighted, k):
    """||out - witness|| over ||witness - a_k I / sqrt(t)||, all in fp64."""
    t = (centered.double() * weighted.double()).sum(dim=(1, 2))[:, None, None] + 1e-5
    eye = torch.eye(witness.shape[-1], dtype=torch.float64, device=witness.device)
    part = witness - eye * 1.5 ** k / torch.sqrt(t)
    return float((out.double() - witness).norm() / part.norm())


def check_subspace_isqrt_fwd(device, dtype, b, n, d, k):
    """Kernel 7 against an fp64 witness, within TOL_SI_F32_RATIO of the plain
    fp32 route's error, and in bf16 also within TOL_SI_BF16 of the plain
    route element by element; the same bits twice.  A control at k = 5: the
    kernel with two bf16 terms a factor, not three."""
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain route in full fp32
    centered, weighted = subspace_inputs(torch.Generator(device=device).manual_seed(11),
                                         b, n, d, dtype)
    before = tsi.subspace_isqrt_fwd.launches
    out = tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5)
    assert tsi.subspace_isqrt_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, d, d) and bool(torch.isfinite(out).all())
    witness = isqrt_cov_subspace(centered.double(), weighted.double(), k, 1e-5)
    plain = isqrt_cov_subspace(centered, weighted, k, 1e-5)
    err = witness_error(out, witness, centered, weighted, k)
    err_plain = witness_error(plain, witness, centered, weighted, k)
    assert err <= TOL_SI_F32_RATIO * err_plain, (err, err_plain)
    if dtype == torch.bfloat16:
        excess, share = bf16_apart(out, plain)
        assert excess <= 1.0 and share <= TOL_SI_BF16[2], (excess, share)
    if k == 5:  # the control: two bf16 terms, not three
        control = tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5, _terms=2)
        if dtype == torch.float32:
            assert witness_error(control, witness, centered, weighted, k) > (
                TOL_SI_F32_RATIO * err_plain)
        else:
            assert bf16_apart(control, plain)[1] > TOL_SI_BF16[2]
    assert torch.equal(tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5), out)
    return (lambda: tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5),
            lambda: isqrt_cov_subspace(centered, weighted, k, 1e-5))


# (rows, W) of the SwiGLU glue: EVA-02-L at 448 served at batch 64, a row count
# that neither a block's eight rows nor the grid divides, the micro EVA's 341
SWIGLU = [(64 * 1025, 2730), (4099, 2730), (4099, 341)]


def swiglu_inputs(device, rows, width, seed=5):
    """g and u ``[rows, P]`` bf16, the padded columns drawn too (the kernel
    must not read them), and the LayerNorm's fp32 weight and bias."""
    padded = width + (-width % 8)
    gen = torch.Generator(device=device).manual_seed(seed)
    g = (1.5 * torch.randn(rows, padded, generator=gen, device=device)).to(torch.bfloat16)
    u = torch.randn(rows, padded, generator=gen, device=device).to(torch.bfloat16)
    w = 1 + 0.3 * torch.randn(width, generator=gen, device=device)
    b = 0.3 * torch.randn(width, generator=gen, device=device)
    return g, u, w, b


def swiglu_excess(out, plain, width):
    """The largest |out - plain| over its tolerance on the true columns."""
    rtol, atol = TOL_SWIGLU
    out, plain = out[:, :width].float(), plain[:, :width].float()
    tol = rtol * plain.abs() + atol * plain.abs().amax(dim=-1, keepdim=True)
    return float(((out - plain).abs() / tol).max())


def check_swiglu_norm_fwd(device, rows, width):
    """Kernel 8 within TOL_SWIGLU of the composition on the true columns, its
    padded columns exactly 0, the same bits twice; controls: gate and value
    swapped (silu(u) g), the bias left out."""
    g, u, w, b = swiglu_inputs(device, rows, width)
    before = tsn.swiglu_norm_fwd.launches
    out = tsn.swiglu_norm_fwd(g, u, w, b, width, 1e-6)
    again = tsn.swiglu_norm_fwd(g, u, w, b, width, 1e-6)
    assert tsn.swiglu_norm_fwd.launches == before + 2
    plain = tsn.swiglu_norm_plain(g, u, w, b, width, 1e-6)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == g.shape
    assert torch.equal(out, again)
    assert torch.equal(out[:, width:], torch.zeros_like(out[:, width:]))
    assert swiglu_excess(out, plain, width) <= 1.0
    swapped = tsn.swiglu_norm_fwd(u, g, w, b, width, 1e-6)
    assert swiglu_excess(swapped, plain, width) > 1.0
    no_bias = tsn.swiglu_norm_fwd(g, u, w, torch.zeros_like(b), width, 1e-6)
    assert swiglu_excess(no_bias, plain, width) > 1.0
    return (lambda: tsn.swiglu_norm_fwd(g, u, w, b, width, 1e-6),
            lambda: tsn.swiglu_norm_plain(g, u, w, b, width, 1e-6))


_BF16 = torch.bfloat16
# every wrapper's calls on the main paths, in bf16 and with each path's own
# options (the dot similarity, five iterations): {wrapper: (check, [arguments
# after the device])}, each a case of the check's list above
MAIN_PATH = {
    "window_attention_fwd": (check_window_attention_fwd, [
        (_BF16, *case, shifted) for case in WA_FWD if case[0] == 64 and case[-1] == WS
        for shifted in ((False, True) if case[1] > WS else (False,))]),
    "window_attention_bwd": (check_window_attention_bwd, [
        (_BF16, *case, shifted) for case in WA_BWD if case[0] == 128
        for shifted in (False, True)]),
    "gpf_fwd": (check_gpf_fwd, [(_BF16, "dot", *case) for case in GPF if case[0] == 64]),
    "gpf_bwd": (check_gpf_bwd, [(_BF16, "dot", *case) for case in GPF_BWD if case[0] == 64]),
    "packed_attention_fwd": (check_packed_attention_fwd, [
        (_BF16, *case) for case in PACKED if case[0] >= 64]),
    "packed_attention_bwd": (check_packed_attention_bwd, [
        (_BF16, *case) for case in PACKED if case[0] == 128]),
    "flash_attention_tiled_fwd": (check_flash_attention_tiled_fwd, [
        (_BF16, *case) for case in FLASH if case[0] >= 64]),
    "flash_attention_tiled_bwd": (check_flash_attention_tiled_bwd, [
        (_BF16, *case) for case in FLASH if case[0] == 128]),
    "newton_schulz_isqrt_fp32_fwd": (check_newton_schulz_isqrt_fp32_fwd, [
        (_BF16, *case) for case in NS if case[0] == 64]),
    "newton_schulz_isqrt_bf16_fwd": (check_newton_schulz_bf16, [
        (_BF16, *case) for case in NS_BF16 if case[0] == "bf16" and case[1] == 64]),
    "newton_schulz_isqrt_bf16_streamed_fwd": (check_newton_schulz_bf16, [
        (_BF16, *case) for case in NS_BF16 if case[0] == "bf16_streamed" and case[1] == 64]),
    "attn_half_fwd": (check_attn_half_fwd, [(_BF16, *case) for case in ATTN_HALF
                                            if case[0] >= 64]),
    "attn_half_bwd": (check_attn_half_bwd, [(_BF16, *case) for case in ATTN_HALF
                                            if case[0] == 128]),
    "subspace_isqrt_fwd": (check_subspace_isqrt_fwd, [(_BF16, *case, 5) for case in SUBSPACE
                                                      if case[0] == 64]),
    "swiglu_norm_fwd": (check_swiglu_norm_fwd, [SWIGLU[0]]),
}
