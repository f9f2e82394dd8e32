"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``cuda`` and skipped without a GPU.  Imports no JAX, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: window attention fp32 1e-4 absolute (sum order); bf16 3.2e-2,
two bf16 ulps at |out| < 4 (the kernel rounds the probabilities to bf16
before P v, the plain version does not).  GPF: each entry within 2e-4 of
``gpf_error_scale``, its own size, and a zeroed off-diagonal fails that.

Backward kernels: dqkv within atol + rtol |ref| of the plain version per
element (fp32 1e-4 + 1e-4, sum order; bf16 2e-2 + 2^-6, two bf16 ulps of the
output's rounding, the plain version rounding P and ds as the kernel does),
dbias within 1e-3 (fp32) / 2e-2 (bf16) of its largest entry; the GPF token
gradients within 1e-3 (fp32) / 2e-2 (bf16) of each row's largest entry and
dc within 1e-3 relative.  Each check also rejects a control.

Packed-layout attention (the ViT's kernels) is held like window attention:
forward fp32 1e-4, bf16 1e-2 + 2^-7 |ref| per element (P rounded to bf16 before
P v on both sides; the kernel rounds the unnormalized probabilities of its
online softmax), its log-sum-exp within 1e-4 of its largest; backward as
above, both sides from the kernel forward's out and lse, also at the edges of
the Hopper kernels' tiles, forward and backward.  Two runs of either give the
same bits.  The GPF kernels are tiled, so they are held at a ViT's 196 tokens and at
784 as well as at 49.

q-tiled attention (kernels 6, 6b; a ViT at 448, 785 tokens): forward fp32
1e-4, bf16 2e-3 + 2^-7 |ref| per element (one ulp of the output's rounding
over a pre-rounding difference far under 2e-3; atol stays under a long
sequence's typical output, ~0.06, so the padded-keys control fails); the
log-sum-exp within 1e-4 of its largest; backward fp32 1e-4 + 1e-4 |ref|, bf16
4e-3 + 2^-6 |ref| (ds rounded on both sides, then the output).  Two runs of
the backward give the same bits.  Newton-Schulz (kernel 5, fp32 inside):
|err| <= rtol |ref| + atol max |ref| with (0, 1e-5) for fp32 M (sum order over
14 chained products) and (2^-7, 1e-4) for bf16 M (one ulp of the output's
rounding); four iterations instead of five fail that.  Kernels 5′ and 5″
(bf16 storage, fp32 sums) are held to (2^-7, 1e-4) against plain versions
that round at the same points, M in either type.

The fused attention half (kernels 4, 4b): forward fp32 1e-4 + 1e-4 |ref|,
bf16 3e-2 + 2^-6 |ref| per element (both sides round xn, qkv, P and om; an
fp32 sum landing on the other side of a rounding moves an ulp through the
proj product, then y rounds); the bias omitted and the residual dropped fall
outside.  Backward: dx as the forward; every parameter gradient within 1e-3
(fp32) / 2e-2 (bf16) of its largest entry; two runs give the same bits.

The Hopper window-attention backward (1b) is also held at the four
Swin-Base stage geometries, a padded Swin-Large canvas and windows of 4 and
8, and the fused half's backward (4b) at token counts that are not
multiples of its 128-row tiles, both at the tolerances above; their bf16
kernels' SASS holds HGMMA and their fp32 bodies' does not.  So are the
Hopper forwards of kernels 1 (windows of 2 to 8, batches of 1 to 64, Swin-
Large/1280 stage 0's padded canvas; per element within 1e-2 + 2^-7 |ref| in
bf16, 1e-4 in fp32) and 2 (token counts at and around its 64- and 128-token
tiles up to 1600, widths 64 to 1536, within 2e-4 of ``gpf_error_scale`` and
exactly symmetric), and 2b at Swin-Large/1280's [1600, 1536].

Kernel 5′ on the Hopper GEMM at every kind of width it takes (826 and 1059,
its ends, padded to 1024 and 1280; 900; the model's 1024), held as 5″ is;
kernel 4's Hopper forward at the main path's own shapes (batch 64 and 128 at
both Swin-Base stages it fuses, both shifts) and at its edges (one image,
one window, an odd window count, windows of 4 and 8), per element within the
fused half's bf16 tolerance above, with its two controls; both kernels'
SASS holds HGMMA.

The data and engine layers on the card: ``DevicePrefetcher`` gives the
batches inline copies give, bit for bit, and a checkpoint GPU -> CPU -> GPU
keeps the model's and the optimizer's state bits.

The token-subspace iSQRT (``kernels/subspace_isqrt.py``, no TPU kernel) at
the main path's shapes (ViT-L/448's N = 784, Swin's 49, ViT at 224's 196)
against an fp64 witness: the error ||out - witness|| over the size of what the
iteration adds to the identity, ||witness - a_k I / sqrt(t)||, is at most twice
the plain fp32 route's (``isqrt_cov_subspace`` on the CUDA cores, TF32 off);
the same kernel with each fp32 operand's lo term dropped (two bf16 terms, not
three) fails that at five iterations.  bf16 inputs give bf16 outputs, whose
rounding hides that norm (both routes read the same ratio, the control too),
so there the outputs are also held element by element against the plain
route's: each within one ulp and a sliver of the largest entry, and few of
them apart at all; the two-term control fails the share at five iterations.

EVA's SwiGLU glue (``kernels/swiglu_norm.py``, no TPU kernel) at EVA-02-L's
serving shape ``[64 x 1025, 2736]`` (W = 2730), at a row count no block or
grid divides and at the micro EVA's 341 -> 344, against its plain version
(the composition under autograd): each element of the true columns within
2^-7 |plain| + 2^-12 of its row's largest |plain| (one bf16 ulp of the
output's rounding over fp32 statistics summed in another order), the padded
columns exactly 0 whatever g and u hold there, two runs the same bits; gate
and value swapped, and the LayerNorm's bias left out, fail that check.  Its
SiLU table gives PyTorch's bf16 SiLU bit for bit for every bf16 input whose
SiLU is normal and within 2^+-100 (h read back through a row built so that
its normalisation is exact).

The spans (``utils/trace.py``): under the profiler, a train step and a
serving call of the Swin-Base/224 flagship and of ViT-L/16 at 448 with the
multi-scale head, and a serving call of EVA-02-L/14 at 448, record one
``emct.kernel.<wrapper>`` range for every count of ``<wrapper>.launches``,
the backward's launches from the autograd thread included.
"""

import numpy as np
import pytest
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 3.2e-2)])
@pytest.mark.parametrize("hp, c, heads, shifted", [(14, 128, 4, True), (7, 256, 8, False)])
def test_cuda_window_attention_matches_plain(cuda_device, dtype, tol, hp, c, heads, shifted):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(2, hp, hp, 3 * c, generator=g, device=cuda_device).to(dtype)
    table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=cuda_device)
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=cuda_device)
    bias = table[idx].reshape(WS * WS, WS * WS, heads).permute(2, 0, 1).contiguous()
    mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, WS, 3), device=cuda_device)
            if shifted else None)
    args = (qkv, bias, mask, heads, WS, (c // heads) ** -0.5)
    before = twa.window_attention_fwd.launches
    out = twa.window_attention_fwd(*args)
    assert twa.window_attention_fwd.launches == before + 1
    ref = twa.window_attention_plain(*args)
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol
    # the check has power: the plain version without its bias falls outside it
    ctrl = twa.window_attention_plain(qkv, torch.zeros_like(bias), *args[2:])
    assert (ctrl.float() - ref.float()).abs().max().item() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("n, d", [(49, 256), (196, 192), (784, 40), (1600, 48)])
def test_cuda_gpf_matches_plain(cuda_device, dtype, similarity, n, d):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ta = torch.randn(4, n, d, generator=g, device=cuda_device).to(dtype)
    tp = torch.randn(4, n, d, generator=g, device=cuda_device).to(dtype)
    c = torch.rand(3, 3, generator=g, device=cuda_device)
    for pos in (ta, tp):
        out = tgpf.gpf_fwd(ta, pos, c, similarity)
        ref = tgpf.gpf_plain(ta, pos, c, similarity)
        scale = tgpf.gpf_error_scale(ta, pos, c, similarity)
        assert out.dtype == torch.float32
        assert ((out - ref).abs() <= 2e-4 * scale).all()
        zeroed = out * torch.eye(n, device=cuda_device)
        assert not ((zeroed - ref).abs() <= 2e-4 * scale).all()


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    qkv = torch.zeros(1, 7, 7, 3 * 96, device=cuda_device)  # head dim 48 is not compiled
    bias = torch.zeros(2, 49, 49, device=cuda_device)
    with pytest.raises(ValueError, match="C / heads"):
        twa.window_attention_fwd(qkv, bias, None, 2, 7, 1.0)
    t = torch.zeros(1, 49, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        tgpf.gpf_fwd(t, t, torch.ones(3, 3, device=cuda_device))


def _close(out, ref, atol, rtol):
    return bool(((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol, btol", [(torch.float32, 1e-4, 1e-4, 1e-3),
                                                     (torch.bfloat16, 2e-2, 2.0**-6, 2e-2)])
@pytest.mark.parametrize("b, hp, c, heads, shifted", [(5, 14, 128, 4, True),
                                                      (3, 7, 256, 8, False)])
def test_cuda_window_attention_bwd_matches_plain(cuda_device, dtype, atol, rtol, btol, b, hp, c,
                                                 heads, shifted):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(b, hp, hp, 3 * c, generator=g, device=cuda_device).to(dtype)
    dout = torch.randn(b, hp, hp, c, generator=g, device=cuda_device).to(dtype)
    table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=cuda_device)
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=cuda_device)
    bias = table[idx].reshape(WS * WS, WS * WS, heads).permute(2, 0, 1).contiguous()
    mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, WS, 3), device=cuda_device)
            if shifted else None)
    args = (qkv, bias, mask, dout, heads, WS, (c // heads) ** -0.5)
    before = twa.window_attention_bwd.launches
    dqkv, dbias = twa.window_attention_bwd(*args)
    assert twa.window_attention_bwd.launches == before + 1
    ref_dqkv, ref_dbias = twa.window_attention_bwd_plain(*args)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert _close(dqkv, ref_dqkv, atol, rtol)
    assert (dbias - ref_dbias).abs().max().item() <= btol * ref_dbias.abs().max().item()
    # controls: dK zeroed, and the bias gradient dropped, both fall outside
    ctrl = ref_dqkv.clone()
    ctrl[..., c:2 * c] = 0
    assert not _close(ctrl, ref_dqkv, atol, rtol)
    assert ref_dbias.abs().max().item() > btol * ref_dbias.abs().max().item()
    # and the Function routes autograd through the same kernels
    q2 = qkv.clone().requires_grad_()
    b2 = bias.clone().requires_grad_()
    twa.window_attention(q2, b2, mask, heads, WS, args[-1]).backward(dout)
    assert torch.equal(q2.grad, dqkv) and torch.equal(b2.grad, dbias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("b, n, d", [(4, 49, 256), (3, 16, 100), (2, 196, 192), (1, 784, 64)])
def test_cuda_gpf_bwd_matches_plain(cuda_device, dtype, tol, similarity, b, n, d):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    ta = torch.randn(b, n, d, generator=g, device=cuda_device).to(dtype)
    tp = torch.randn(b, n, d, generator=g, device=cuda_device).to(dtype)
    c = torch.rand(3, 3, generator=g, device=cuda_device) + 0.05
    cot = torch.randn(b, n, n, generator=g, device=cuda_device)

    def rows_close(out, ref):
        scale = ref.float().abs().amax(dim=-1, keepdim=True)
        return bool(((out.float() - ref.float()).abs() <= tol * scale).all())

    for pos in (tp, ta):
        before = tgpf.gpf_bwd.launches
        dta, dtp, dc = tgpf.gpf_bwd(ta, pos, c, cot, similarity)
        assert tgpf.gpf_bwd.launches == before + 1
        rta, rtp, rdc = tgpf.gpf_bwd_plain(ta, pos, c, cot, similarity)
        assert dta.dtype == dtype and dc.dtype == torch.float32 and dc.shape == (b, 3, 3)
        assert rows_close(dta, rta) and rows_close(dtp, rtp)
        assert ((dc - rdc).abs() <= 1e-3 * rdc.abs().amax()).all()
        # controls: the dR^T half of dX dropped (half the gradient), dc zeroed
        assert not rows_close(0.5 * rta.float(), rta)
        assert not ((torch.zeros_like(rdc) - rdc).abs() <= 1e-3 * rdc.abs().amax()).all()
    # one tensor as both token sets: autograd adds the two gradients
    x = ta.clone().requires_grad_()
    tgpf.gpf(x, x, c, similarity).backward(cot)
    rta, rtp, _ = tgpf.gpf_bwd_plain(ta, ta, c, cot, similarity)
    assert rows_close(x.grad, rta.float() + rtp.float())


# The Hopper backward of kernel 2b (csrc/gpf_bwd_sm90.cuh, the bf16 dX on
# wgmma from W split in two bf16 terms, and gpf_bwd.cu's wgmma Gram) at the
# edges of its tiles: one token, one under, at and over a 64-token tile, the
# Swin, ViT/224, ViT/448 and ViT-Large/512 token counts and 785; widths of
# one 64-feature box, one TMA cannot take (100), ViT-Base's and ViT-Large's.
# fp32 (the CUDA-core bodies) at the same shapes.
GPF_BWD_N = (1, 49, 63, 64, 65, 196, 784, 785, 1024)
GPF_BWD_D = (64, 100, 768, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("d", GPF_BWD_D)
@pytest.mark.parametrize("n", GPF_BWD_N)
def test_cuda_gpf_bwd_sm90_edges(cuda_device, n, d, similarity, dtype, tol):
    """2b against its plain version, two distinct token sets and one tensor
    twice: token gradients within tol of each row's largest entry and dc
    within 1e-3 of its largest (the tolerances above), one launch a call, the
    same bits twice.  The cotangent is zeroed where the pre-activation lies
    within 1e-4 of its error scale of zero, as chip_smoke.py does: on the
    clamp's kink the two sides' Grams, summed in other orders, may take
    different branches.  With one token under cosine the exact token
    gradients are zero (a single token's cosine Gram is 1 whatever the
    token), so both sides hold rounding noise and are held to 1e-5 absolute
    there."""
    _gpf_bwd_edge(cuda_device, n, d, similarity, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("n, d", [(1600, 1536), (1600, 100)])
def test_cuda_gpf_bwd_sm90_swin_large(cuda_device, n, d, similarity, dtype, tol):
    """2b as above at the largest token count the wrappers admit
    (``gpf.MAX_TOKENS``, Swin-Large/1280's 1600 tokens) at its width, 1536,
    and at a width TMA cannot take."""
    _gpf_bwd_edge(cuda_device, n, d, similarity, dtype, tol)


def _gpf_bwd_edge(cuda_device, n, d, similarity, dtype, tol):
    b = 2 if n <= 196 else 1
    g = torch.Generator(device=cuda_device).manual_seed(n * 7 + d)
    ta = torch.randn(b, n, d, generator=g, device=cuda_device).to(dtype)
    tp = torch.randn(b, n, d, generator=g, device=cuda_device).to(dtype)
    c = torch.rand(3, 3, generator=g, device=cuda_device) + 0.05
    cot = torch.randn(b, n, n, generator=g, device=cuda_device)
    zero_exact = n == 1 and similarity == "cosine"

    def off_the_kink(pos):
        pre = gpf_fuse(token_similarity_graph(ta, similarity, 1e-6),
                       token_similarity_graph(pos, similarity, 1e-6), c, symmetric_enforce=True,
                       clamp=False)
        band = 1e-4 * tgpf.gpf_error_scale(ta, pos, c, similarity, 1e-6, True)
        return torch.where(pre.abs() <= band, torch.zeros_like(cot), cot)

    def rows_close(out, ref):
        if zero_exact:
            return bool((out.float().abs() <= 1e-5).all() and (ref.float().abs() <= 1e-5).all())
        scale = ref.float().abs().amax(dim=-1, keepdim=True)
        return bool(((out.float() - ref.float()).abs() <= tol * scale).all())

    for pos in (tp, ta):
        cot_pos = off_the_kink(pos)
        before = tgpf.gpf_bwd.launches
        dta, dtp, dc = tgpf.gpf_bwd(ta, pos, c, cot_pos, similarity)
        assert tgpf.gpf_bwd.launches == before + 1
        rta, rtp, rdc = tgpf.gpf_bwd_plain(ta, pos, c, cot_pos, similarity)
        assert dta.dtype == dtype and dtp.shape == (b, n, d)
        assert rows_close(dta, rta) and rows_close(dtp, rtp)
        assert ((dc - rdc).abs() <= 1e-3 * rdc.abs().amax()).all()
        if not zero_exact:  # a control: half the gradient
            assert not rows_close(0.5 * rta.float(), rta)
        again = tgpf.gpf_bwd(ta, pos, c, cot_pos, similarity)
        assert all(torch.equal(x, y) for x, y in zip(again, (dta, dtp, dc)))


def _sass_functions(path):
    """{kernel's mangled name: its SASS} of a built library (cuobjdump)."""
    import shutil
    import subprocess
    from pathlib import Path

    from ego_moment_cle_vit_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = ""
        elif name:
            out[name] += line + "\n"
    return out


@pytest.mark.cuda
def test_cuda_new_hopper_kernels_hold_wgmma(cuda_device):
    """The bf16 w and dX kernels of 2b, 5″'s GEMM and the bf16 bodies of
    kernels 1 and 2 issue HGMMA, and the CUDA-core bodies (2b's fp32
    kernels, 5″'s Mn / rescale kernels, the fp32 forwards of 1 and 2) do
    not."""
    from ego_moment_cle_vit_tpu_torch.kernels import _build

    names = ("gpf_bwd", "newton_schulz_bf16_streamed", "window_attention_fwd", "gpf_fwd")
    paths = _build.build(names)
    fns = {k: v for name in names for k, v in _sass_functions(paths[name]).items()}
    wgmma = {name: "HGMMA" in sass for name, sass in fns.items()}
    for key in ("gpf_bwd_w_sm90", "gpf_sm909dx_kernel", "gemm_sm90_kernel",
                "window_attention_fwd_sm90", "gpf_fwd_sm90"):
        hits = [has for name, has in wgmma.items() if key in name]
        assert hits and all(hits), (key, wgmma)
    for key in ("gpf_bwd_w_kernel", "gpf_fp329dx_kernel", "init_kernel", "finish_kernel",
                "window_attention_fwd_f32", "gpf_fwd_kernel"):
        hits = [has for name, has in wgmma.items() if key in name]
        assert hits and not any(hits), (key, wgmma)


# (B, W, T, C, heads, bias heads or None, mask groups or None): the ViT call at
# two widths, a Swin packed shape with everything switched on, shared bias and
# mask, and the longest group the wrappers admit
PACKED = [(3, 1, 197, 768, 12, None, None), (2, 1, 197, 192, 3, None, None),
          (3, 4, 98, 128, 4, 4, 4), (2, 3, 50, 128, 2, 1, 1), (2, 1, 256, 64, 2, 2, None)]


def _packed(device, dtype, b, w, t, c, heads, hb, wm):
    g = torch.Generator(device=device).manual_seed(3)
    qkv = torch.randn(b, w, t, 3 * c, generator=g, device=device).to(dtype)
    dout = torch.randn(b, w, t, c, generator=g, device=device).to(dtype)
    bias = torch.randn(hb, t, t, generator=g, device=device) if hb else None
    mask = (torch.where(torch.rand(wm, t, t, generator=g, device=device) < 0.2, -100.0, 0.0)
            if wm else None)
    return qkv, dout, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 1e-2, 2.0**-7)])
@pytest.mark.parametrize("b, w, t, c, heads, hb, wm", PACKED)
def test_cuda_packed_attention_matches_plain(cuda_device, dtype, atol, rtol, b, w, t, c, heads,
                                             hb, wm):
    qkv, _, bias, mask = _packed(cuda_device, dtype, b, w, t, c, heads, hb, wm)
    before = tpa.packed_attention_fwd.launches
    out = tpa.packed_attention_fwd(qkv, bias, mask, heads)
    assert tpa.packed_attention_fwd.launches == before + 1
    ref, ref_lse = tpa.packed_attention_plain(qkv, bias, mask, heads, return_lse=True)
    assert out.dtype == dtype and out.shape == (b, w, t, c)
    assert _close(out, ref, atol, rtol)
    # the log-sum-exp the training forward asks for, and the same output with it
    out_lse, lse = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=True)
    assert torch.equal(out_lse, out) and lse.shape == (b * w, heads, t)
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * ref_lse.abs().max().item()
    # controls: the padded keys left unmasked (zero keys join the softmax), and
    # the bias dropped, both fall outside
    pad = -(-t // 64) * 64 - t
    if pad:
        padded = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
        pb = None if bias is None else torch.nn.functional.pad(bias, (0, pad, 0, pad))
        pm = None if mask is None else torch.nn.functional.pad(mask, (0, pad, 0, pad))
        ctrl = tpa.packed_attention_plain(padded, pb, pm, heads)[:, :, :t]
        assert not _close(ctrl, ref, atol, rtol)
    if bias is not None:
        assert not _close(tpa.packed_attention_plain(qkv, None, mask, heads), ref, atol, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol, btol", [(torch.float32, 1e-4, 1e-4, 1e-3),
                                                     (torch.bfloat16, 2e-2, 2.0**-6, 2e-2)])
@pytest.mark.parametrize("b, w, t, c, heads, hb, wm", PACKED)
def test_cuda_packed_attention_bwd_matches_plain(cuda_device, dtype, atol, rtol, btol, b, w, t,
                                                 c, heads, hb, wm):
    qkv, dout, bias, mask = _packed(cuda_device, dtype, b, w, t, c, heads, hb, wm)
    out, lse = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=True)
    before = tpa.packed_attention_bwd.launches
    dqkv, dbias = tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads)
    assert tpa.packed_attention_bwd.launches == before + 1
    ref_dqkv, ref_dbias = tpa.packed_attention_bwd_plain(qkv, bias, mask, out, lse, dout, heads)
    assert dqkv.dtype == dtype and _close(dqkv, ref_dqkv, atol, rtol)
    ctrl = ref_dqkv.clone()
    ctrl[..., c:2 * c] = 0  # a control: dK zeroed falls outside
    assert not _close(ctrl, ref_dqkv, atol, rtol)
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


@pytest.mark.cuda
def test_cuda_packed_attention_rejects_bad_inputs(cuda_device):
    qkv = torch.zeros(1, 1, 9, 3 * 96, device=cuda_device)  # head dim 48 is not compiled
    with pytest.raises(ValueError, match="C / heads"):
        tpa.packed_attention_fwd(qkv, None, None, 2)
    long = torch.zeros(1, 1, 785, 3 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="T <= 256"):
        tpa.packed_attention_fwd(long, None, None, 1)
    ok = torch.zeros(1, 2, 9, 3 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="bias must be float32"):
        tpa.packed_attention_fwd(ok, torch.zeros(3, 9, 9, device=cuda_device), None, 2)
    out, lse = tpa.packed_attention_fwd(ok, None, None, 2, return_lse=True)
    with pytest.raises(ValueError, match="dout must be"):
        tpa.packed_attention_bwd(ok, None, None, out, lse,
                                 torch.zeros(1, 2, 9, 32, device=cuda_device), 2)
    with pytest.raises(ValueError, match="lse must be"):
        tpa.packed_attention_bwd(ok, None, None, out, lse.double(), torch.zeros_like(out), 2)


# The Hopper backward (csrc/attention_bwd_sm90.cuh) at the edges of its tiles:
# one token, one under, at and over a 64-token tile, ViT-Base/224's 197, 200
# (a whole 16-column last tile) and the longest packed group; heads of 32 and
# 64; without and with bias and mask.
SM90_T = (1, 63, 64, 65, 197, 200, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("c, heads", [(128, 4), (128, 2)])
@pytest.mark.parametrize("t", SM90_T)
def test_cuda_packed_attention_bwd_sm90_edges(cuda_device, t, c, heads, extras):
    """bf16 3b against its plain version from the kernel forward's out and
    lse, dqkv per element within 2e-2 + 2^-6 |ref| and dbias within 2e-2 of
    its largest entry (the tolerances above); at one token the exact dbias is
    zero (P = 1, ds = dp - delta = 0), so both sides hold rounding noise only
    and dbias is held to 1e-4 absolute there.  Two runs give the same bits;
    dK zeroed falls outside."""
    atol, rtol, btol = 2e-2, 2.0**-6, 2e-2
    w = 2 if extras else 1
    qkv, dout, bias, mask = _packed(cuda_device, torch.bfloat16, 3, w, t, c, heads,
                                    heads if extras else None, w if extras else None)
    out, lse = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=True)
    dqkv, dbias = tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads)
    ref, ref_dbias = tpa.packed_attention_bwd_plain(qkv, bias, mask, out, lse, dout, heads)
    assert torch.isfinite(dqkv.float()).all() and _close(dqkv, ref, atol, rtol)
    ctrl = ref.clone()
    ctrl[..., c:2 * c] = 0
    assert t == 1 or not _close(ctrl, ref, atol, rtol)
    if extras:
        err = (dbias - ref_dbias).abs().max().item()
        assert err <= (1e-4 if t == 1 else btol * ref_dbias.abs().max().item())
    again, dbias_again = tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads)
    assert torch.equal(again, dqkv) and (dbias is None or torch.equal(dbias_again, dbias))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [257, 785, 1025])
def test_cuda_flash_attention_bwd_sm90_long(cuda_device, t):
    """bf16 6b past the packed kernel's 256 tokens, at ViT-Base/448's and
    ViT-Large/512's lengths, two heads of 64: within 4e-3 + 2^-6 |ref| of the
    plain version (as above), the same bits twice, dK zeroed outside."""
    atol, rtol = 4e-3, 2.0**-6
    g = torch.Generator(device=cuda_device).manual_seed(9)
    qkv = torch.randn(2, t, 3 * 128, generator=g, device=cuda_device).to(torch.bfloat16)
    dout = torch.randn(2, t, 128, generator=g, device=cuda_device).to(torch.bfloat16)
    out, lse = tfa.flash_attention_tiled_fwd(qkv, 2)
    dqkv = tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, 2)
    ref = tfa.flash_attention_tiled_bwd_plain(qkv, dout, 2)
    assert _close(dqkv, ref, atol, rtol)
    ctrl = ref.clone()
    ctrl[..., 128:256] = 0
    assert not _close(ctrl, ref, atol, rtol)
    assert torch.equal(tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, 2), dqkv)


@pytest.mark.cuda
def test_cuda_attention_bwd_sm90_two_blocks_an_sm(cuda_device):
    """The register cap holds: two blocks of each bf16 backward kernel share
    an SM (uncapped, the dk/dv kernel takes ~186 registers a thread and runs
    one)."""
    occ = tfa.bwd_occupancy()
    assert occ["dq_blocks_per_sm"] >= 2 and occ["dkv_blocks_per_sm"] >= 2, occ


# The Hopper forward (csrc/attention_fwd_sm90.cuh) at the edges of its tiles:
# one token, one under, at and over 16 (wgmma's N and k-step), 64 (a key tile,
# a warpgroup's rows) and 128 (a block's rows), ViT-Base/224's 197, 200 and
# around the longest packed group; heads of 32 and 64; without and with bias
# and mask; without and with the log-sum-exp.
SM90_FWD_T = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 197, 200, 255, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("c, heads", [(128, 4), (128, 2)])
@pytest.mark.parametrize("t", SM90_FWD_T)
def test_cuda_packed_attention_fwd_sm90_edges(cuda_device, t, c, heads, extras, with_lse):
    """bf16 kernel 3 against its plain version per element within 1e-2 +
    2^-7 |ref| (the tolerance above), its lse within 1e-4 of the largest
    plain log-sum-exp; two runs give the same bits.  A control: the keys
    padded to 64 and left unmasked fall outside the lse check, and outside
    the output check too unless a single key is padded (one zero key among
    64 or more moves an output by less than its tolerance)."""
    atol, rtol = 1e-2, 2.0**-7
    w = 2 if extras else 1
    qkv, _, bias, mask = _packed(cuda_device, torch.bfloat16, 3, w, t, c, heads,
                                 heads if extras else None, w if extras else None)
    res = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=with_lse)
    out, lse = res if with_lse else (res, None)
    ref, ref_lse = tpa.packed_attention_plain(qkv, bias, mask, heads, return_lse=True)
    assert out.shape == (3, w, t, c) and torch.isfinite(out.float()).all()
    assert _close(out, ref, atol, rtol)
    if with_lse:
        assert lse.shape == (3 * w, heads, t)
        assert (lse - ref_lse).abs().max().item() <= 1e-4 * ref_lse.abs().max().item()
    again = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=with_lse)
    assert torch.equal(again[0] if with_lse else again, out)
    assert lse is None or torch.equal(again[1], lse)
    pad = -(-t // 64) * 64 - t
    if pad:
        padded = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
        pb = None if bias is None else torch.nn.functional.pad(bias, (0, pad, 0, pad))
        pm = None if mask is None else torch.nn.functional.pad(mask, (0, pad, 0, pad))
        ctrl, ctrl_lse = tpa.packed_attention_plain(padded, pb, pm, heads, return_lse=True)
        lse_off = (ctrl_lse[..., :t] - ref_lse).abs().max().item()
        assert lse_off > 1e-4 * ref_lse.abs().max().item()
        assert pad == 1 or not _close(ctrl[:, :, :t], ref, atol, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [257, 785, 800, 1025])
def test_cuda_flash_attention_fwd_sm90_long(cuda_device, t):
    """bf16 kernel 6 past the packed kernel's 256 tokens (785 at ViT-Base/448,
    800 a whole last key tile, 1025 at ViT-Large/512), two heads of 64:
    within 2e-3 + 2^-7 |ref| of the plain version (as above), lse within 1e-4
    of the largest plain log-sum-exp, the same bits twice, the keys padded to
    64 and left unmasked outside."""
    atol, rtol = 2e-3, 2.0**-7
    g = torch.Generator(device=cuda_device).manual_seed(10)
    qkv = torch.randn(2, t, 3 * 128, generator=g, device=cuda_device).to(torch.bfloat16)
    out, lse = tfa.flash_attention_tiled_fwd(qkv, 2)
    ref, ref_lse = tfa.flash_attention_tiled_plain(qkv, 2)
    assert _close(out, ref, atol, rtol)
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * ref_lse.abs().max().item()
    again, lse_again = tfa.flash_attention_tiled_fwd(qkv, 2)
    assert torch.equal(again, out) and torch.equal(lse_again, lse)
    padded = torch.nn.functional.pad(qkv, (0, 0, 0, -(-t // 64) * 64 - t))
    assert not _close(tfa.flash_attention_tiled_plain(padded, 2)[0][:, :t], ref, atol, rtol)


@pytest.mark.cuda
def test_cuda_attention_fwd_sm90_two_blocks_an_sm(cuda_device):
    """The design's occupancy holds: the bf16 forward fits 128 registers a
    thread, and two blocks (two consumer warpgroups each) share an SM."""
    occ = tfa.fwd_occupancy()
    assert occ["registers"] <= 128 and occ["blocks_per_sm"] >= 2, occ


# (B, T, C, heads): the ViT-Base call at 448, two heads of 64 and of 32 past
# the packed kernel's 256 tokens, a sequence under one query block, one tile
FLASH = [(2, 785, 768, 12), (2, 300, 128, 2), (3, 325, 64, 2), (2, 100, 64, 2), (2, 64, 128, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 2e-3, 2.0**-7)])
@pytest.mark.parametrize("b, t, c, heads", FLASH)
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, atol, rtol, b, t, c, heads):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    qkv = torch.randn(b, t, 3 * c, generator=g, device=cuda_device).to(dtype)
    before = tfa.flash_attention_tiled_fwd.launches
    out, lse = tfa.flash_attention_tiled_fwd(qkv, heads)
    assert tfa.flash_attention_tiled_fwd.launches == before + 1
    ref, ref_lse = tfa.flash_attention_tiled_plain(qkv, heads)
    assert out.dtype == dtype and out.shape == (b, t, c) and lse.shape == (b, heads, t)
    assert _close(out, ref, atol, rtol)
    assert (lse - ref_lse).abs().max().item() <= 1e-4 * ref_lse.abs().max().item()
    # a control: the keys padded to the kernel's tile and left unmasked
    pad = -(-t // tfa.TILE) * tfa.TILE - t
    if pad:
        padded = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
        assert not _close(tfa.flash_attention_tiled_plain(padded, heads)[0][:, :t], ref, atol,
                          rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 4e-3, 2.0**-6)])
@pytest.mark.parametrize("b, t, c, heads", FLASH)
def test_cuda_flash_attention_bwd_matches_plain(cuda_device, dtype, atol, rtol, b, t, c, heads):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(b, t, 3 * c, generator=g, device=cuda_device).to(dtype)
    dout = torch.randn(b, t, c, generator=g, device=cuda_device).to(dtype)
    out, lse = tfa.flash_attention_tiled_fwd(qkv, heads)
    before = tfa.flash_attention_tiled_bwd.launches
    dqkv = tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, heads)
    assert tfa.flash_attention_tiled_bwd.launches == before + 1
    ref = tfa.flash_attention_tiled_bwd_plain(qkv, dout, heads)
    assert dqkv.dtype == dtype and _close(dqkv, ref, atol, rtol)
    ctrl = ref.clone()
    ctrl[..., c:2 * c] = 0  # a control: dK zeroed falls outside
    assert not _close(ctrl, ref, atol, rtol)
    # the same gradient twice, bit for bit
    assert torch.equal(tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, heads), dqkv)
    # and the Function routes autograd through the same kernels
    q2 = qkv.clone().requires_grad_()
    tfa.flash_attention_tiled(q2, heads).backward(dout)
    assert torch.equal(q2.grad, dqkv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol, atol", [(torch.float32, 0.0, 1e-5),
                                               (torch.bfloat16, 2.0**-7, 1e-4)])
@pytest.mark.parametrize("b, d", [(4, 768), (2, 192), (2, 100), (3, 64)])
def test_cuda_newton_schulz_matches_plain(cuda_device, dtype, rtol, atol, b, d):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    z = torch.randn(b, d + 16, d, generator=g, device=cuda_device)
    m = (z.transpose(1, 2) @ z / d).to(dtype)

    def close(out, ref):
        ref = ref.float()
        return bool(((out.float() - ref).abs() <= rtol * ref.abs() + atol * ref.abs().max()).all())

    before = tns.newton_schulz_isqrt_fp32_fwd.launches
    out = tns.newton_schulz_isqrt_fwd(m, 5, 1e-5)  # the dispatch: the fp32 kernel at D <= 825
    assert tns.newton_schulz_isqrt_fp32_fwd.launches == before + 1
    ref = tns.newton_schulz_isqrt_plain(m, 5, 1e-5)
    assert out.dtype == dtype and close(out, ref)
    assert not close(tns.newton_schulz_isqrt_plain(m, 4, 1e-5), ref)  # a control
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


@pytest.mark.cuda
def test_cuda_long_sequence_wrappers_reject_bad_inputs(cuda_device):
    qkv = torch.zeros(1, 785, 3 * 96, device=cuda_device)  # head dim 48 is not compiled
    with pytest.raises(ValueError, match="C / heads"):
        tfa.flash_attention_tiled_fwd(qkv, 2)
    ok = torch.zeros(1, 300, 3 * 64, device=cuda_device)
    out, lse = tfa.flash_attention_tiled_fwd(ok, 2)
    with pytest.raises(ValueError, match="lse must be"):
        tfa.flash_attention_tiled_bwd(ok, out, lse.double(), torch.zeros_like(out), 2)
    with pytest.raises(ValueError, match="D <= 825"):
        tns.newton_schulz_isqrt_fp32_fwd(torch.zeros(1, 1024, 1024, device=cuda_device))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tns.newton_schulz_isqrt_fwd(torch.zeros(1, 1100, 1100, device=cuda_device))
    with pytest.raises(TypeError, match="not supported"):
        tns.newton_schulz_isqrt_fwd(torch.zeros(1, 64, 64, device=cuda_device,
                                                dtype=torch.float16))


# (variant, B, D): the two model widths, a width the bf16 kernels pad (900 ->
# 1024) and the streamed grouping at its TPU grid's smallest width
NS_BF16 = [("bf16", 2, 1024), ("bf16_streamed", 1, 1536), ("bf16", 2, 900),
           ("bf16_streamed", 2, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant, b, d", NS_BF16)
def test_cuda_newton_schulz_bf16_matches_plain(cuda_device, dtype, variant, b, d):
    """Kernels 5′ / 5″ against their plain versions, which round at the same
    points: |err| <= 2^-7 |ref| + 1e-4 max |ref| per element (an fp32 sum
    taken in another order lands on the other side of a bf16 rounding, one
    ulp, carried at the size of the entries); four iterations fail that; two
    runs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    z = torch.randn(b, d + 64, d, generator=g, device=cuda_device)
    m = (z.transpose(1, 2) @ z / (d + 64)).to(dtype)
    fwd, plain = {
        "bf16": (tns.newton_schulz_isqrt_bf16_fwd, tns.newton_schulz_isqrt_bf16_plain),
        "bf16_streamed": (tns.newton_schulz_isqrt_bf16_streamed_fwd,
                          tns.newton_schulz_isqrt_bf16_streamed_plain),
    }[variant]

    def close(out, ref):
        ref = ref.float()
        return bool(((out.float() - ref).abs()
                     <= 2.0**-7 * ref.abs() + 1e-4 * ref.abs().max()).all())

    before = fwd.launches
    out = fwd(m, 5, 1e-5)
    assert fwd.launches == before + 1
    ref = plain(m, 5, 1e-5)
    assert out.dtype == dtype and out.shape == m.shape and close(out, ref)
    assert torch.equal(fwd(m, 5, 1e-5), out)
    assert not close(plain(m, 4, 1e-5), ref)  # a control
    assert close(fwd(m, 0, 1e-5), plain(m, 0, 1e-5))  # I / sqrt(tr), no product
    if tns.variant_for(d) == variant:
        # the dispatch picks this kernel, and the Function differentiates the
        # plain fp32 iteration
        x = m.clone().requires_grad_()
        y = tns.newton_schulz_isqrt_kernel(x, 5, 1e-5)
        assert torch.equal(y, out) and fwd.launches == before + 4
        cot = torch.randn(m.shape, generator=g, device=cuda_device).to(dtype)
        y.backward(cot)
        x_ref = m.clone().requires_grad_()
        tns.newton_schulz_isqrt_plain(x_ref, 5, 1e-5).backward(cot)
        assert torch.equal(x.grad, x_ref.grad)


@pytest.mark.cuda
def test_cuda_newton_schulz_bf16_rejects_bad_inputs(cuda_device):
    for fwd in (tns.newton_schulz_isqrt_bf16_fwd, tns.newton_schulz_isqrt_bf16_streamed_fwd):
        with pytest.raises(TypeError, match="not supported"):
            fwd(torch.zeros(1, 64, 64, device=cuda_device, dtype=torch.float16))
        with pytest.raises(ValueError, match="B, D, D"):
            fwd(torch.zeros(1, 64, 32, device=cuda_device))
        with pytest.raises(ValueError, match="contiguous"):
            fwd(torch.zeros(1, 64, 64, device=cuda_device).transpose(1, 2))
        with pytest.raises(ValueError, match="num_iterations"):
            fwd(torch.zeros(1, 64, 64, device=cuda_device), -1)


# 5″ on its Hopper GEMM (csrc/ns_sm90.cuh): the TPU grid's widths up to the
# model's, M in either type
NS_STREAMED = [(1, 512), (3, 1024), (2, 1536)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, d", NS_STREAMED)
def test_cuda_newton_schulz_streamed_sm90(cuda_device, b, d, dtype):
    """5″ against its plain version at chip_smoke.py's TOL_NS_BF16, |err| <=
    2^-7 |ref| + 5e-4 max |ref| (both sides round at the same points); four
    iterations fail that; two runs give the same bits; one step, which runs
    no product, the plain version's bits."""
    g = torch.Generator(device=cuda_device).manual_seed(11 + d)
    z = torch.randn(b, d + 64, d, generator=g, device=cuda_device)
    m = (z.transpose(1, 2) @ z / (d + 64)).to(dtype)

    def close(out, ref):
        ref = ref.float()
        return bool(((out.float() - ref).abs()
                     <= 2.0**-7 * ref.abs() + 5e-4 * ref.abs().max()).all())

    fwd = tns.newton_schulz_isqrt_bf16_streamed_fwd
    out = fwd(m, 5, 1e-5)
    ref = tns.newton_schulz_isqrt_bf16_streamed_plain(m, 5, 1e-5)
    assert out.dtype == dtype and close(out, ref)
    assert not close(tns.newton_schulz_isqrt_bf16_streamed_plain(m, 4, 1e-5), ref)
    assert torch.equal(fwd(m, 5, 1e-5), out)
    assert torch.equal(fwd(m, 1, 1e-5), tns.newton_schulz_isqrt_bf16_streamed_plain(m, 1, 1e-5))


@pytest.mark.cuda
def test_cuda_newton_schulz_streamed_refuses_a_ragged_width(cuda_device):
    """D = 640 is no multiple of the GEMM's 256-column tile: the wrapper
    raises, and the C entry refuses it too (cudaErrorInvalidValue) rather
    than run it another way."""
    import ctypes

    from ego_moment_cle_vit_tpu_torch.kernels import _build

    m = torch.eye(640, device=cuda_device)[None]
    with pytest.raises(ValueError, match="multiple of 256"):
        tns.newton_schulz_isqrt_bf16_streamed_fwd(m)
    lib = _build.load("newton_schulz_bf16_streamed", tns._BF16_STREAMED_SIGNATURES)
    work = torch.empty(5 * 640 * 640, dtype=torch.bfloat16, device=cuda_device)
    out = torch.empty_like(m)
    tr = torch.full((1,), 640.0, device=cuda_device)
    rc = lib.newton_schulz_isqrt_bf16_streamed(m.data_ptr(), out.data_ptr(), work.data_ptr(),
                                               tr.data_ptr(), 1, 640, 5, 0,
                                               ctypes.c_void_p(_build.stream_ptr(m.device)))
    assert rc == 1  # cudaErrorInvalidValue


# 5′ on the Hopper GEMM (csrc/ns_sm90.cuh): both ends of its widths (826
# and 1059, padded to 1024 and 1280), a width between and the model's 1024
NS_BF16_SM90 = (826, 900, 1024, 1059)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("d", NS_BF16_SM90)
def test_cuda_newton_schulz_bf16_sm90(cuda_device, b, d, dtype):
    """5′ against its plain version at chip_smoke.py's TOL_NS_BF16, |err| <=
    2^-7 |ref| + 5e-4 max |ref| (both sides round at the same points); four
    iterations fail that; two runs give the same bits; one step, which runs
    no product, the plain version's bits."""
    g = torch.Generator(device=cuda_device).manual_seed(13 + d + b)
    z = torch.randn(b, d + 64, d, generator=g, device=cuda_device)
    m = (z.transpose(1, 2) @ z / (d + 64)).to(dtype)

    def close(out, ref):
        ref = ref.float()
        return bool(((out.float() - ref).abs()
                     <= 2.0**-7 * ref.abs() + 5e-4 * ref.abs().max()).all())

    fwd, plain = tns.newton_schulz_isqrt_bf16_fwd, tns.newton_schulz_isqrt_bf16_plain
    before = fwd.launches
    out = fwd(m, 5, 1e-5)
    assert fwd.launches == before + 1
    ref = plain(m, 5, 1e-5)
    assert out.dtype == dtype and out.shape == m.shape and close(out, ref)
    assert not close(plain(m, 4, 1e-5), ref)
    assert torch.equal(fwd(m, 5, 1e-5), out)
    assert torch.equal(fwd(m, 1, 1e-5), plain(m, 1, 1e-5))


@pytest.mark.cuda
def test_cuda_newton_schulz_bf16_refuses_widths_outside_its_own(cuda_device):
    """5′ takes 826 <= D <= 1059, the widths the dispatch gives it; the
    wrapper raises outside them rather than run them another way."""
    for d in (825, 1060, 1536):
        with pytest.raises(ValueError, match="826 <= D <= 1059"):
            tns.newton_schulz_isqrt_bf16_fwd(torch.eye(d, device=cuda_device)[None])


# (B, Hp, C, heads, shifted): stage 0 and stage 1 shapes of Swin-Base at a
# small batch, and a padded canvas (16 tokens pad to 21)
ATTN_HALF = [(2, 14, 128, 4, True), (2, 7, 256, 8, False), (1, 21, 128, 4, True)]


def _attn_half_inputs(device, dtype, b, hp, c, heads, shifted):
    g = torch.Generator(device=device).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    table = randn((2 * WS - 1) ** 2, heads)
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=device)
    bias = table[idx].reshape(WS * WS, WS * WS, heads).permute(2, 0, 1).contiguous()
    mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, WS, 3), device=device)
            if shifted else None)
    args = (randn(b, hp, hp, c).to(dtype), 1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
            randn(3 * c, c, scale=c ** -0.5).to(dtype), randn(3 * c, scale=0.1).to(dtype),
            randn(c, c, scale=c ** -0.5).to(dtype), randn(c, scale=0.1).to(dtype), bias, mask)
    return args, randn(b, hp, hp, c).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 3e-2, 2.0**-6)])
@pytest.mark.parametrize("b, hp, c, heads, shifted", ATTN_HALF)
def test_cuda_attn_half_matches_plain(cuda_device, dtype, atol, rtol, b, hp, c, heads, shifted):
    args, _ = _attn_half_inputs(cuda_device, dtype, b, hp, c, heads, shifted)
    before = tah.attn_half_fwd.launches
    out = tah.attn_half_fwd(*args, heads, WS)
    assert tah.attn_half_fwd.launches == before + 1
    ref = tah.attn_half_plain(*args, heads, WS)
    assert out.dtype == dtype and _close(out, ref, atol, rtol)
    # controls: the bias omitted, and the residual dropped, both fall outside
    no_bias = args[:7] + (torch.zeros_like(args[7]), args[8])
    assert not _close(tah.attn_half_plain(*no_bias, heads, WS), ref, atol, rtol)
    assert not _close(ref.float() - args[0].float(), ref, atol, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol, gtol", [(torch.float32, 1e-4, 1e-4, 1e-3),
                                                     (torch.bfloat16, 3e-2, 2.0**-6, 2e-2)])
@pytest.mark.parametrize("b, hp, c, heads, shifted", ATTN_HALF)
def test_cuda_attn_half_bwd_matches_plain(cuda_device, dtype, atol, rtol, gtol, b, hp, c, heads,
                                          shifted):
    args, dy = _attn_half_inputs(cuda_device, dtype, b, hp, c, heads, shifted)
    before = tah.attn_half_bwd.launches
    got = tah.attn_half_bwd(*args, dy, heads, WS)
    assert tah.attn_half_bwd.launches == before + 1
    ref = tah.attn_half_bwd_plain(*args, dy, heads, WS)
    assert got[0].dtype == dtype and _close(got[0], ref[0], atol, rtol)
    for a, r in zip(got[1:], ref[1:]):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert (a - r).abs().max().item() <= gtol * r.abs().max().item()
    # the same gradients twice, bit for bit
    assert all(torch.equal(a, r) for a, r in zip(tah.attn_half_bwd(*args, dy, heads, WS), got))
    # and the Function routes autograd through the same kernels
    leaves = [t.clone().requires_grad_() for t in args[:8]]
    tah.attn_half(*leaves, args[8], heads, WS).backward(dy)
    for leaf, want in zip(leaves, got):
        assert torch.equal(leaf.grad, want.to(leaf.dtype))


@pytest.mark.cuda
def test_cuda_attn_half_rejects_bad_inputs(cuda_device):
    args, _ = _attn_half_inputs(cuda_device, torch.float32, 1, 7, 128, 4, False)
    with pytest.raises(ValueError, match="C / heads"):
        tah.attn_half_fwd(*args, 2, WS)  # head dim 64 is not compiled
    with pytest.raises(ValueError, match="wqkv must be"):
        tah.attn_half_fwd(args[0], args[1], args[2], args[3].bfloat16(), *args[4:], 4, WS)
    with pytest.raises(TypeError, match="not supported"):
        tah.attn_half_fwd(args[0].double(), *args[1:3], *(t.double() for t in args[3:7]),
                          *args[7:], 4, WS)


# kernel 4's Hopper forward (bf16): the main path's launches (batch 64 serving,
# 128 training, Swin-Base stages 0 and 1), one image, a single window (an odd
# window count leaves a block's second warpgroup without one), three windows,
# and windows of 4 and 8 (nine windows) with random tables and masks:
# (B, Hp, C, heads, ws)
ATTN_HALF_FWD_SM90 = [(64, 56, 128, 4, 7), (64, 28, 256, 8, 7), (128, 56, 128, 4, 7),
                      (128, 28, 256, 8, 7), (1, 56, 128, 4, 7), (1, 7, 256, 8, 7),
                      (3, 7, 128, 4, 7), (2, 16, 128, 4, 4), (1, 24, 256, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("b, hp, c, heads, ws", ATTN_HALF_FWD_SM90)
def test_cuda_attn_half_fwd_sm90_shapes(cuda_device, b, hp, c, heads, ws, shifted):
    """Kernel 4 in bf16 within chip_smoke.py's TOL_AH, 3e-2 + 2^-6 |ref| per
    element, of its plain version; the bias omitted and the residual dropped
    fall outside; one launch a call; the same bits twice."""
    if ws == WS:
        args, _ = _attn_half_inputs(cuda_device, torch.bfloat16, b, hp, c, heads, shifted)
    else:
        g = torch.Generator(device=cuda_device).manual_seed(hp * 17 + ws)
        nt, nw = ws * ws, (hp // ws) ** 2

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device=cuda_device) * scale

        mask = randn(nw, nt, nt, scale=3.0) if shifted else None
        args = (randn(b, hp, hp, c).bfloat16(), 1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
                randn(3 * c, c, scale=c ** -0.5).bfloat16(), randn(3 * c, scale=0.1).bfloat16(),
                randn(c, c, scale=c ** -0.5).bfloat16(), randn(c, scale=0.1).bfloat16(),
                randn(heads, nt, nt), mask)
    atol, rtol = 3e-2, 2.0**-6
    before = tah.attn_half_fwd.launches
    out = tah.attn_half_fwd(*args, heads, ws)
    assert tah.attn_half_fwd.launches == before + 1
    ref = tah.attn_half_plain(*args, heads, ws)
    assert out.dtype == torch.bfloat16 and _close(out, ref, atol, rtol)
    no_bias = args[:7] + (torch.zeros_like(args[7]), args[8])
    assert not _close(tah.attn_half_plain(*no_bias, heads, ws), ref, atol, rtol)
    assert not _close(ref.float() - args[0].float(), ref, atol, rtol)
    assert torch.equal(tah.attn_half_fwd(*args, heads, ws), out)


@pytest.mark.cuda
def test_cuda_newton_schulz_bf16_and_attn_half_fwd_hold_wgmma(cuda_device):
    """5′'s GEMM and kernel 4's bf16 body issue HGMMA; 5′'s Mn / rescale
    kernels and kernel 4's fp32 body do not."""
    from ego_moment_cle_vit_tpu_torch.kernels import _build

    names = ("newton_schulz_bf16", "attn_half_fwd")
    paths = _build.build(names)
    fns = {k: v for name in names for k, v in _sass_functions(paths[name]).items()}
    wgmma = {name: "HGMMA" in sass for name, sass in fns.items()}
    for key in ("gemm_sm90_kernel", "attn_half_fwd_sm90"):
        hits = [has for name, has in wgmma.items() if key in name]
        assert hits and all(hits), (key, wgmma)
    for key in ("init_kernel", "finish_kernel", "attn_half_fwd_f32"):
        hits = [has for name, has in wgmma.items() if key in name]
        assert hits and not any(hits), (key, wgmma)


# the window-attention backward's Hopper kernel (1b): the four Swin-Base stage
# geometries at a small batch, a padded Swin-Large canvas (84 = 12 windows of
# 7, the pad sentinel in the mask), and windows of 4 and 8 with tables and
# masks drawn at random: (B, Hp, C, heads, ws)
WA_BWD_SM90 = [(3, 56, 128, 4, 7), (4, 28, 256, 8, 7), (5, 14, 512, 16, 7), (6, 7, 1024, 32, 7),
               (2, 84, 576, 18, 7), (3, 16, 128, 4, 4), (2, 24, 64, 2, 8), (9, 8, 96, 3, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol, btol", [(torch.float32, 1e-4, 1e-4, 1e-3),
                                                     (torch.bfloat16, 2e-2, 2.0**-6, 2e-2)])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("b, hp, c, heads, ws", WA_BWD_SM90)
def test_cuda_window_attention_bwd_sm90_shapes(cuda_device, dtype, atol, rtol, btol, b, hp, c,
                                               heads, ws, shifted):
    g = torch.Generator(device=cuda_device).manual_seed(hp * 131 + ws)
    nt, nw = ws * ws, (hp // ws) ** 2
    qkv = torch.randn(b, hp, hp, 3 * c, generator=g, device=cuda_device).to(dtype)
    dout = torch.randn(b, hp, hp, c, generator=g, device=cuda_device).to(dtype)
    if ws == WS:
        table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=cuda_device)
        idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=cuda_device)
        bias = table[idx].reshape(nt, nt, heads).permute(2, 0, 1).contiguous()
        h = hp - 4 if hp == 84 else hp  # Swin-Large/1280 stage 2: 80 tokens padded to 84
        mask = (torch.as_tensor(_attn_mask(h, h, hp, hp, WS, 3 if shifted else 0),
                                device=cuda_device) if shifted or h != hp else None)
    else:
        bias = torch.randn(heads, nt, nt, generator=g, device=cuda_device)
        mask = (torch.randn(nw, nt, nt, generator=g, device=cuda_device) * 3 if shifted else None)
    args = (qkv, bias, mask, dout, heads, ws, (c // heads) ** -0.5)
    dqkv, dbias = twa.window_attention_bwd(*args)
    ref_dqkv, ref_dbias = twa.window_attention_bwd_plain(*args)
    assert _close(dqkv, ref_dqkv, atol, rtol)
    assert (dbias - ref_dbias).abs().max().item() <= btol * ref_dbias.abs().max().item()
    again = twa.window_attention_bwd(*args)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


# the fused attention half's backward (4b) where its tiles end: token counts
# that are not multiples of 128 (441, 588, 1225) at both widths
ATTN_HALF_SM90 = [(1, 21, 128, 4), (3, 14, 256, 8), (1, 35, 256, 8), (2, 28, 128, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol, gtol", [(torch.float32, 1e-4, 1e-4, 1e-3),
                                                     (torch.bfloat16, 3e-2, 2.0**-6, 2e-2)])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("b, hp, c, heads", ATTN_HALF_SM90)
def test_cuda_attn_half_bwd_sm90_shapes(cuda_device, dtype, atol, rtol, gtol, b, hp, c, heads,
                                        shifted):
    args, dy = _attn_half_inputs(cuda_device, dtype, b, hp, c, heads, shifted)
    got = tah.attn_half_bwd(*args, dy, heads, WS)
    ref = tah.attn_half_bwd_plain(*args, dy, heads, WS)
    assert _close(got[0], ref[0], atol, rtol)
    for a, r in zip(got[1:], ref[1:]):
        assert (a - r).abs().max().item() <= gtol * r.abs().max().item()
    assert all(torch.equal(a, r) for a, r in zip(tah.attn_half_bwd(*args, dy, heads, WS), got))


@pytest.mark.cuda
def test_cuda_window_and_attn_half_bwd_hold_wgmma(cuda_device):
    """1b's and 4b's bf16 kernels issue HGMMA; their fp32 bodies do not."""
    from ego_moment_cle_vit_tpu_torch.kernels import _build

    paths = _build.build(("window_attention_bwd", "attn_half_bwd"))
    fns = {**_sass_functions(paths["window_attention_bwd"]),
           **_sass_functions(paths["attn_half_bwd"])}
    wgmma = {name: "HGMMA" in sass for name, sass in fns.items()}
    for key in ("window_attention_bwd_sm90", "ah_bwd_qkv_do", "ah_bwd_dx", "ah_bwd_wgrad"):
        hits = [has for name, has in wgmma.items() if key in name]
        assert hits and all(hits), (key, wgmma)
    for key in ("window_attention_bwd_f32", "attn_half_bwd_attention", "attn_half_bwd_dx",
                "attn_half_bwd_wgrad", "attn_half_bwd_layer_norm"):
        hits = [has for name, has in wgmma.items() if key in name]
        assert hits and not any(hits), (key, wgmma)


# The Hopper window-attention forward (kernel 1, bf16; fp32 keeps its CUDA-core
# body) at the edges of its geometry: windows of 2, 4, 7 and 8, batches of 1,
# 5 and 64 (image chunks of one image, a ragged last chunk, many images a
# block), the four Swin-Base stages, and Swin-Large/1280 stage 0's padded
# canvas (322 = 46 windows of 7, C = 192, 6 heads) with the pad sentinel in
# its masks: (B, Hp, C, heads, ws)
WA_FWD_SM90 = [(1, 56, 128, 4, 7), (5, 28, 256, 8, 7), (64, 14, 512, 16, 7), (64, 7, 1024, 32, 7),
               (2, 322, 192, 6, 7), (64, 16, 128, 4, 4), (5, 24, 64, 2, 8), (1, 8, 96, 3, 8),
               (5, 6, 64, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 1e-2, 2.0**-7)])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("b, hp, c, heads, ws", WA_FWD_SM90)
def test_cuda_window_attention_fwd_sm90_shapes(cuda_device, dtype, atol, rtol, b, hp, c, heads,
                                               ws, shifted):
    """Kernel 1 within atol + rtol |ref| of its plain version per element
    (chip_smoke.py's TOL_WA: fp32 by sum order; bf16 by P rounded to bf16
    before P v plus one ulp of the output's rounding), the bias omitted
    falling outside, one launch a call, the same bits twice.  Windows of 7
    take Swin's tables and masks (the padded canvas a mask even unshifted,
    ``mask=None`` otherwise); other windows random tables and masks."""
    g = torch.Generator(device=cuda_device).manual_seed(hp * 131 + ws * 7 + b)
    nt, nw = ws * ws, (hp // ws) ** 2
    qkv = torch.randn(b, hp, hp, 3 * c, generator=g, device=cuda_device).to(dtype)
    if ws == WS:
        table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=cuda_device)
        idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=cuda_device)
        bias = table[idx].reshape(nt, nt, heads).permute(2, 0, 1).contiguous()
        h = hp - 2 if hp == 322 else hp  # Swin-Large/1280 stage 0: 320 tokens padded to 322
        mask = (torch.as_tensor(_attn_mask(h, h, hp, hp, WS, 3 if shifted else 0),
                                device=cuda_device) if (shifted and hp > WS) or h != hp else None)
    else:
        bias = torch.randn(heads, nt, nt, generator=g, device=cuda_device)
        mask = (torch.randn(nw, nt, nt, generator=g, device=cuda_device) * 3 if shifted else None)
    args = (qkv, bias, mask, heads, ws, (c // heads) ** -0.5)
    before = twa.window_attention_fwd.launches
    out = twa.window_attention_fwd(*args)
    assert twa.window_attention_fwd.launches == before + 1
    ref = twa.window_attention_plain(*args)
    assert out.dtype == dtype and _close(out, ref, atol, rtol)
    ctrl = twa.window_attention_plain(qkv, torch.zeros_like(bias), *args[2:])
    assert not _close(ctrl, ref, atol, rtol)
    assert torch.equal(twa.window_attention_fwd(*args), out)


# kernel 2's Hopper body (bf16 tokens) where its tiles end: one token, one
# under, at and over a 64- and a 128-token tile, and the ViT and Swin-Large
# paths' token counts (196, 784, 1024, 1600), at widths of one 64-feature box,
# one TMA cannot take (100), ViT-Base's and Swin-Large's
GPF_FWD_N = (1, 63, 64, 65, 127, 128, 129, 196, 784, 1024, 1600)
GPF_FWD_D = (64, 100, 768, 1536)


@pytest.mark.cuda
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("d", GPF_FWD_D)
@pytest.mark.parametrize("n", GPF_FWD_N)
def test_cuda_gpf_fwd_sm90_edges(cuda_device, n, d, similarity):
    """Kernel 2 in bf16 against its plain version with one tensor twice and
    with two: each entry within 2e-4 of ``gpf_error_scale`` (the tolerance
    above), the output exactly symmetric, a zeroed off-diagonal falling
    outside, one launch a call, the same bits twice.  Degrees 2 x 2 (the
    flagship's, whose polynomial the kernel unrolls) and, with two tensors,
    1 x 3 (the loop that reads the degrees at run time)."""
    b = 2 if n <= 196 else 1
    g = torch.Generator(device=cuda_device).manual_seed(n * 11 + d)
    ta = torch.randn(b, n, d, generator=g, device=cuda_device).to(torch.bfloat16)
    tp = torch.randn(b, n, d, generator=g, device=cuda_device).to(torch.bfloat16)
    c22 = torch.rand(3, 3, generator=g, device=cuda_device)
    c13 = torch.rand(2, 4, generator=g, device=cuda_device)
    for pos, c in ((ta, c22), (tp, c22), (tp, c13)):
        before = tgpf.gpf_fwd.launches
        out = tgpf.gpf_fwd(ta, pos, c, similarity)
        assert tgpf.gpf_fwd.launches == before + 1
        ref = tgpf.gpf_plain(ta, pos, c, similarity)
        scale = tgpf.gpf_error_scale(ta, pos, c, similarity)
        assert out.dtype == torch.float32 and out.shape == (b, n, n)
        assert ((out - ref).abs() <= 2e-4 * scale).all()
        assert torch.equal(out, out.transpose(1, 2))
        if n > 1:
            zeroed = out * torch.eye(n, device=cuda_device)
            assert not ((zeroed - ref).abs() <= 2e-4 * scale).all()
        assert torch.equal(tgpf.gpf_fwd(ta, pos, c, similarity), out)


@pytest.mark.cuda
def test_cuda_device_prefetcher_equals_inline_copies(cuda_device):
    """20 host batches through ``DevicePrefetcher`` at depth 2 equal inline
    ``.to("cuda")`` copies of the same batches, bit for bit, read on the
    consuming stream while the side stream copies the next ones."""
    from ego_moment_cle_vit_tpu_torch.data import DevicePrefetcher

    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8),
             rng.integers(0, 80, (16,)).astype(np.int32)) for _ in range(20)]
    seen = 0
    for (images, labels), (ref_i, ref_l) in zip(DevicePrefetcher(iter(host), cuda_device, 2),
                                               host):
        assert images.device.type == "cuda" and images.dtype == torch.uint8
        # work on the consuming stream between batches, as a step would do
        (images.float() @ torch.ones(3, 3, device=cuda_device)).sum()
        assert torch.equal(images, torch.from_numpy(ref_i).to(cuda_device))
        assert torch.equal(labels, torch.from_numpy(ref_l).to(cuda_device))
        seen += 1
    assert seen == 20


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_gpu_cpu_gpu(cuda_device, tmp_path):
    """A checkpoint written on the GPU, restored on the CPU, written there and
    restored on the GPU again gives the same model and optimizer state bits
    (bf16 weights with fp32 masters, a factored leaf, two updates taken)."""
    from ego_moment_cle_vit_tpu_torch import create_model
    from ego_moment_cle_vit_tpu_torch.train import state as tstate

    cfg = {"model": {"backbone_name": "swin_micro_patch4_window7_56", "bf16": True,
                     "moment": {"d_out": 32, "sketch_dim": 128}},
           "data": {"input_size": 56},
           "training": {"optimizer": {"factored_threshold": 10_000}}}

    def build(device):
        model = create_model(cfg, num_classes=5, device=device, seed=0)
        return model, tstate.create_train_state(model, cfg, 3, device=device)

    model, state = build("cuda")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(2):
        state.optimizer.step({n: torch.randn(p.shape, generator=g, device=cuda_device).to(
            p.dtype) for n, p in state.optimizer.params.items()})
        state.step += 1
    tstate.save_checkpoint(str(tmp_path / "gpu"), state, 1, 0.5, cfg)
    cpu_model, cpu_state = build("cpu")
    bundle = tstate.restore_checkpoint(str(tmp_path / "gpu" / "checkpoint_epoch_1"), device="cpu")
    cpu_model.load_state_dict(bundle["model"])
    cpu_state.optimizer.load_state_dict(bundle["optimizer"])
    cpu_state.step = bundle["step"]
    tstate.save_checkpoint(str(tmp_path / "cpu"), cpu_state, 1, 0.5, cfg)
    back_model, back_state = build("cuda")
    bundle = tstate.restore_checkpoint(str(tmp_path / "cpu" / "checkpoint_epoch_1"), device="cuda")
    back_model.load_state_dict(bundle["model"])
    back_state.optimizer.load_state_dict(bundle["optimizer"])
    for (n, p), q in zip(model.state_dict().items(), back_model.state_dict().values()):
        assert q.device.type == "cuda" and torch.equal(p, q), n
    mine, theirs = state.optimizer.state_dict(), back_state.optimizer.state_dict()
    assert mine["master"] and mine["v_row"]
    for key in ("master", "m", "v", "v_row", "v_col", "ema"):
        assert all(torch.equal(t, theirs[key][n]) for n, t in mine[key].items()), key
    assert theirs["count"] == 2 and bundle["step"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_adaptive_gpf_global_launches_the_gpf_kernels(cuda_device, dtype):
    """``AdaptiveGraphPolynomialFusion('global')`` runs kernels 2 / 2b once
    each, a forward and a backward, and gives the static module's output and
    gradients bit for bit on the same coefficients; 'attention' and
    'spatial' launch neither."""
    from ego_moment_cle_vit_tpu_torch.models.gpf import (
        AdaptiveGraphPolynomialFusion,
        GraphPolynomialFusion,
    )

    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(8, 49, 256, generator=g, device=cuda_device).to(dtype)
    p = torch.randn(8, 49, 256, generator=g, device=cuda_device).to(dtype)
    static = GraphPolynomialFusion(similarity="dot", device=cuda_device)
    static.reset_parameters(g)
    outs, grads = {}, {}
    for name in ("static", "global", "attention", "spatial"):
        mod = static if name == "static" else AdaptiveGraphPolynomialFusion(
            similarity="dot", adaptive_type=name, num_tokens=49, dim=256, dtype=dtype,
            device=cuda_device)
        if name != "static":
            mod.alpha_coeffs.data.copy_(static.alpha_coeffs)
        ta, tp = a.clone().requires_grad_(), p.clone().requires_grad_()
        before = (tgpf.gpf_fwd.launches, tgpf.gpf_bwd.launches)
        out = mod(ta, tp)
        out.square().sum().backward()
        torch.cuda.synchronize()
        launched = (tgpf.gpf_fwd.launches - before[0], tgpf.gpf_bwd.launches - before[1])
        assert launched == ((1, 1) if name in ("static", "global") else (0, 0)), name
        outs[name], grads[name] = out, (ta.grad, tp.grad, mod.alpha_coeffs.grad)
    assert torch.equal(outs["global"], outs["static"])
    for got, ref in zip(grads["global"], grads["static"]):
        assert torch.equal(got, ref)


KERNEL_WRAPPERS = (tah.attn_half_fwd, tah.attn_half_bwd, tfa.flash_attention_tiled_fwd,
                   tfa.flash_attention_tiled_bwd, tgpf.gpf_fwd, tgpf.gpf_bwd,
                   tns.newton_schulz_isqrt_fp32_fwd, tns.newton_schulz_isqrt_bf16_fwd,
                   tns.newton_schulz_isqrt_bf16_streamed_fwd, tpa.packed_attention_fwd,
                   tpa.packed_attention_bwd, twa.window_attention_fwd, twa.window_attention_bwd,
                   tsi.subspace_isqrt_fwd, tsn.swiglu_norm_fwd)


def _flagship_config(backbone, size, resize, **model):
    return {"model": {"backbone_name": backbone, "norm": "layer", "bf16": True,
                      "gpf": {"degree_p": 2, "degree_q": 2, "similarity": "dot"},
                      "moment": {"d_out": 1024, "use_third_order": True, "isqrt_iterations": 5,
                                 "sketch_dim": 4096, "bf16_params": True},
                      "classifier": {"fusion_type": "add"}, **model},
            "data": {"input_size": size, "resize_size": resize},
            "training": {"optimizer": {"lr": 3e-4, "factored_large_leaves": True},
                         "scheduler": {"warmup_epochs": 0},
                         "loss": {"lambda_triplet": 0.6, "lambda_align": 0.1, "margin": 0.3},
                         "epochs": 1}}


# the benchmark's two configurations, with the launches a step and a call
SPAN_CONFIGS = {
    "swinB-224": (_flagship_config("swin_base_patch4_window7_224", 224, 256),
                  {"window_attention_fwd": 24, "window_attention_bwd": 24, "gpf_fwd": 1,
                   "gpf_bwd": 1},
                  {"window_attention_fwd": 24, "gpf_fwd": 1, "subspace_isqrt_fwd": 1}),
    "vitL-448-ms": (_flagship_config("vit_large_patch16_224", 448, 600, backbone_remat="block",
                                     classifier={"fusion_type": "add", "type": "multiscale"}),
                    {"flash_attention_tiled_fwd": 48, "flash_attention_tiled_bwd": 24,
                     "gpf_fwd": 1, "gpf_bwd": 1},
                    {"flash_attention_tiled_fwd": 24, "gpf_fwd": 1, "subspace_isqrt_fwd": 1}),
    # served only: no cell trains EVA
    "eva02L-448": (_flagship_config("eva02_large_patch14_448", 448, 600), None,
                   {"flash_attention_tiled_fwd": 24, "gpf_fwd": 1,
                    "newton_schulz_isqrt_bf16_fwd": 1, "swiglu_norm_fwd": 24}),
}


def _kernel_spans_and_launches(fn):
    """Run ``fn`` once under the profiler: (the ``emct.kernel.<wrapper>``
    ranges it recorded on the host, the launch counters' increments), by
    wrapper, zeros left out."""
    before = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    launched = {w.__name__: w.launches - before[w.__name__] for w in KERNEL_WRAPPERS}
    spans = {}
    for e in prof.events():
        if (e.name.startswith("emct.kernel.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            key = e.name[len("emct.kernel."):]
            spans[key] = spans.get(key, 0) + 1
    return spans, {k: n for k, n in launched.items() if n}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPAN_CONFIGS))
def test_cuda_kernel_spans_count_the_launches(cuda_device, name):
    from ego_moment_cle_vit_tpu_torch import (
        create_model,
        create_train_state,
        make_infer_fn,
        make_train_step,
    )
    from ego_moment_cle_vit_tpu_torch.data import AugmentConfig

    cfg, train_launches, serve_launches = SPAN_CONFIGS[name]
    model = create_model(cfg, 80, device=cuda_device)
    aug = AugmentConfig(**cfg["data"])
    if train_launches is not None:
        state = create_train_state(model, cfg, 1000, device=cuda_device)
        step = make_train_step(model, aug, device=cuda_device)
    infer = make_infer_fn(model, aug, device=cuda_device)
    s = cfg["data"]["resize_size"]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.randint(0, 256, (4, s, s, 3), generator=g, device=cuda_device,
                           dtype=torch.uint8)
    labels = torch.tensor([1, 7, 1, 30], device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def train():
        step(state, images, labels, gen)

    def serve():
        infer(images).float().cpu()

    for fn, expected in ((train, train_launches), (serve, serve_launches)):
        if expected is None:
            continue
        fn()  # kernels built and loaded, cuBLAS initialized
        spans, launched = _kernel_spans_and_launches(fn)
        assert launched == expected, (fn.__name__, launched)
        assert spans == launched, (fn.__name__, spans)


# (B, N, D) of the subspace iSQRT: ViT-L/16 at 448, Swin's last stage at batch
# 64, ViT-Base at 224
SUBSPACE = [(4, 784, 1024), (64, 49, 1024), (8, 196, 768)]


def _subspace_inputs(device, b, n, d, dtype, seed=11):
    """centered and weighted as the moment head makes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randn(b, n, d, generator=g, device=device).to(dtype)
    graph = torch.rand(b, n, n, generator=g, device=device)
    w = normalize_graph(0.5 * (graph + graph.transpose(1, 2)), "symmetric", eps=1e-5)
    centered = tokens - graph_weighted_mean(tokens, w, eps=1e-5)[:, None, :]
    weighted = torch.matmul(w.float(), centered.float()).to(dtype)
    return centered.contiguous(), weighted.contiguous()


# bf16 outputs against the plain route's, chip_smoke.py's TOL_SI_BF16: per
# element |err| <= 2^-7 |plain| + 1e-4 max |plain|, and at most 3.5e-4 of the
# elements apart (an H100 at k = 5: 1.1e-4 to 1.8e-4 on sound runs, 6.9e-4 to
# 5.1e-3 with the lo terms dropped; 1.5e-5 to 6.5e-5 at k = 3)
TOL_SI_BF16 = (2.0**-7, 1e-4, 3.5e-4)


def _bf16_apart(out, plain):
    """The largest |out - plain| over its per-element tolerance, and the
    share of elements that differ."""
    rtol, atol, _ = TOL_SI_BF16
    out, plain = out.float(), plain.float()
    tol = rtol * plain.abs() + atol * plain.abs().max()
    return float(((out - plain).abs() / tol).max()), float((out != plain).double().mean())


def _witness_error(out, witness, centered, weighted, k):
    """||out - witness|| over ||witness - a_k I / sqrt(t)||, all in fp64."""
    t = (centered.double() * weighted.double()).sum(dim=(1, 2))[:, None, None] + 1e-5
    eye = torch.eye(witness.shape[-1], dtype=torch.float64, device=witness.device)
    part = witness - eye * 1.5 ** k / torch.sqrt(t)
    return float((out.double() - witness).norm() / part.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("b, n, d", SUBSPACE)
def test_cuda_subspace_isqrt_meets_the_fp64_bar(cuda_device, b, n, d, k, dtype):
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain route in full fp32
    centered, weighted = _subspace_inputs(cuda_device, b, n, d, dtype)
    before = tsi.subspace_isqrt_fwd.launches
    out = tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5)
    assert tsi.subspace_isqrt_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, d, d) and bool(torch.isfinite(out).all())
    witness = isqrt_cov_subspace(centered.double(), weighted.double(), k, 1e-5)
    plain = isqrt_cov_subspace(centered, weighted, k, 1e-5)
    err = _witness_error(out, witness, centered, weighted, k)
    err_plain = _witness_error(plain, witness, centered, weighted, k)
    assert err <= 2 * err_plain, (err, err_plain)
    if dtype == torch.bfloat16:
        excess, share = _bf16_apart(out, plain)
        assert excess <= 1.0 and share <= TOL_SI_BF16[2], (excess, share)
    if k == 5:  # the control: two bf16 terms, not three
        control = tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5, _terms=2)
        if dtype == torch.float32:
            assert _witness_error(control, witness, centered, weighted, k) > 2 * err_plain
        else:
            assert _bf16_apart(control, plain)[1] > TOL_SI_BF16[2]
    assert torch.equal(tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5), out)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 2])
def test_cuda_subspace_isqrt_closed_form_iterations(cuda_device, k):
    """k = 0 (I / sqrt(t)), 1 (no product before the last) and 2 (S X and S H
    only) against the fp64 witness, with the fp32 bar."""
    centered, weighted = _subspace_inputs(cuda_device, 3, 130, 256, torch.float32)
    out = tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5)
    witness = isqrt_cov_subspace(centered.double(), weighted.double(), k, 1e-5)
    plain = isqrt_cov_subspace(centered, weighted, k, 1e-5)
    if k == 0:
        torch.testing.assert_close(out.double(), witness, rtol=1e-6, atol=0)
        return
    err = _witness_error(out, witness, centered, weighted, k)
    assert err <= 2 * _witness_error(plain, witness, centered, weighted, k)


@pytest.mark.cuda
def test_cuda_subspace_isqrt_counts_one_launch_and_span(cuda_device):
    centered, weighted = _subspace_inputs(cuda_device, 2, 49, 128, torch.bfloat16)
    tsi.subspace_isqrt_fwd(centered, weighted, 5)  # built and loaded
    spans, launched = _kernel_spans_and_launches(
        lambda: tsi.subspace_isqrt_fwd(centered, weighted, 5))
    assert launched == {"subspace_isqrt_fwd": 1}
    assert spans == launched


@pytest.mark.cuda
def test_cuda_subspace_isqrt_rejects_bad_inputs(cuda_device):
    c = torch.zeros(2, 16, 64, device=cuda_device)
    with pytest.raises(TypeError, match="centered is"):
        tsi.subspace_isqrt_fwd(c, c.to(torch.bfloat16), 3)
    with pytest.raises(ValueError, match="one \\[B, N, D\\] shape"):
        tsi.subspace_isqrt_fwd(c, c[:, :8], 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        tsi.subspace_isqrt_fwd(c[..., :60].contiguous(), c[..., :60].contiguous(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tsi.subspace_isqrt_fwd(c.transpose(0, 1), c.transpose(0, 1), 3)
    with pytest.raises(TypeError, match="not supported"):
        tsi.subspace_isqrt_fwd(c.half(), c.half(), 3)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tsi.subspace_isqrt_fwd(c, c.cpu(), 3)
    with pytest.raises(ValueError, match="terms must be 3"):
        tsi.subspace_isqrt_fwd(c, c, 3, _terms=1)


@pytest.mark.cuda
def test_cuda_subspace_isqrt_holds_wgmma(cuda_device):
    """Its products run on HGMMA; the trace, split and identity kernels do
    not."""
    from ego_moment_cle_vit_tpu_torch.kernels import _build

    fns = _sass_functions(_build.build(("subspace_isqrt",))["subspace_isqrt"])
    wgmma = {name: "HGMMA" in sass for name, sass in fns.items()}
    products = [has for name, has in wgmma.items() if "product_kernel" in name]
    assert products and all(products), wgmma
    others = [has for name, has in wgmma.items() if "product_kernel" not in name]
    assert others and not any(others), wgmma


# (rows, W) of the SwiGLU glue: EVA-02-L at 448 served at batch 64, a row count
# that neither a block's eight rows nor the grid divides, the micro EVA's 341
SWIGLU = [(64 * 1025, 2730), (4099, 2730), (4099, 341)]
# per element of the true columns, |err| <= 2^-7 |plain| + 2^-12 max |row|:
# one bf16 ulp of the output's rounding, over fp32 statistics and affine
# summed in another order (a few fp32 ulps of the row's scale)
TOL_SWIGLU = (2.0**-7, 2.0**-12)


def _swiglu_inputs(device, rows, width, seed=5):
    """g and u ``[rows, P]`` bf16, the padded columns drawn too (the kernel
    must not read them), and the LayerNorm's fp32 weight and bias."""
    padded = width + (-width % 8)
    gen = torch.Generator(device=device).manual_seed(seed)
    g = (1.5 * torch.randn(rows, padded, generator=gen, device=device)).to(torch.bfloat16)
    u = torch.randn(rows, padded, generator=gen, device=device).to(torch.bfloat16)
    w = 1 + 0.3 * torch.randn(width, generator=gen, device=device)
    b = 0.3 * torch.randn(width, generator=gen, device=device)
    return g, u, w, b


def _swiglu_excess(out, plain, width):
    """The largest |out - plain| over its tolerance on the true columns."""
    rtol, atol = TOL_SWIGLU
    out, plain = out[:, :width].float(), plain[:, :width].float()
    tol = rtol * plain.abs() + atol * plain.abs().amax(dim=-1, keepdim=True)
    return float(((out - plain).abs() / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows, width", SWIGLU)
def test_cuda_swiglu_norm_matches_plain(cuda_device, rows, width):
    g, u, w, b = _swiglu_inputs(cuda_device, rows, width)
    before = tsn.swiglu_norm_fwd.launches
    out = tsn.swiglu_norm_fwd(g, u, w, b, width, 1e-6)
    again = tsn.swiglu_norm_fwd(g, u, w, b, width, 1e-6)
    assert tsn.swiglu_norm_fwd.launches == before + 2
    plain = tsn.swiglu_norm_plain(g, u, w, b, width, 1e-6)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == g.shape
    assert torch.equal(out, again)
    assert torch.equal(out[:, width:], torch.zeros_like(out[:, width:]))
    assert _swiglu_excess(out, plain, width) <= 1.0
    # controls: gate and value swapped (silu(u) g); the bias left out
    swapped = tsn.swiglu_norm_fwd(u, g, w, b, width, 1e-6)
    assert _swiglu_excess(swapped, plain, width) > 1.0
    no_bias = tsn.swiglu_norm_fwd(g, u, w, torch.zeros_like(b), width, 1e-6)
    assert _swiglu_excess(no_bias, plain, width) > 1.0


@pytest.mark.cuda
def test_cuda_swiglu_norm_silu_has_the_composition_bits(cuda_device):
    """SiLU comes from a table of every bf16 input, so h = bf16(silu(g) u)
    must have the composition's bits.  A row for each bf16 g whose SiLU lies
    in [2^-100, 2^100] in magnitude (or is 0): [g, 0 x 7] times u = 2^-k with
    |h| in [2^-5, 2^-4), w = 1, b = 0 and eps = 2^20, so that var + eps rounds
    to eps in either summation order and column 1, -mean rsqrt(eps), is
    -h / 8 * 2^-10 exactly in bf16: it shows h."""
    x = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x.to(cuda_device)
    s = torch.nn.functional.silu(x).float()
    keep = (s == 0) | ((s.abs() >= 2.0**-100) & (s.abs() <= 2.0**100))
    x, s = x[keep], s[keep]
    k = torch.where(s == 0, torch.zeros_like(s), torch.floor(torch.log2(s.abs())) + 5)
    g = torch.zeros(len(x), 8, dtype=torch.bfloat16, device=cuda_device)
    u = torch.zeros_like(g)
    g[:, 0], u[:, 0] = x, torch.exp2(-k).to(torch.bfloat16)
    w = torch.ones(8, device=cuda_device)
    out = tsn.swiglu_norm_fwd(g, u, w, torch.zeros_like(w), 8, 2.0**20)
    h = (torch.nn.functional.silu(g) * u)[:, 0]
    assert len(x) > 50000
    assert torch.equal(out[:, 1], (-h.float() * 2.0**-13).to(torch.bfloat16))


@pytest.mark.cuda
def test_cuda_swiglu_norm_counts_one_launch_and_span(cuda_device):
    g, u, w, b = _swiglu_inputs(cuda_device, 64, 2730)
    tsn.swiglu_norm_fwd(g, u, w, b, 2730, 1e-6)  # built and loaded
    spans, launched = _kernel_spans_and_launches(
        lambda: tsn.swiglu_norm_fwd(g, u, w, b, 2730, 1e-6))
    assert launched == {"swiglu_norm_fwd": 1}
    assert spans == launched


@pytest.mark.cuda
def test_cuda_swiglu_norm_rejects_bad_inputs(cuda_device):
    g, u, w, b = _swiglu_inputs(cuda_device, 16, 2730)
    with pytest.raises(TypeError, match="must be bfloat16"):
        tsn.swiglu_norm_fwd(g.float(), u.float(), w, b, 2730, 1e-6)
    with pytest.raises(TypeError, match="must be float32"):
        tsn.swiglu_norm_fwd(g, u, w.bfloat16(), b.bfloat16(), 2730, 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        wide = torch.ones(2737, device=cuda_device)
        tsn.swiglu_norm_fwd(g, u, wide, wide, 2737, 1e-6)
    with pytest.raises(ValueError, match="multiple of 8"):
        tsn.swiglu_norm_fwd(g[:, :2730].contiguous(), u[:, :2730].contiguous(), w, b, 2730, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        tsn.swiglu_norm_fwd(torch.cat([g, g], dim=-1)[:, :2736], u, w, b, 2730, 1e-6)
    with pytest.raises(RuntimeError, match="one CUDA device"):
        tsn.swiglu_norm_fwd(g, u, w.cpu(), b.cpu(), 2730, 1e-6)
