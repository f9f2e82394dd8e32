"""Each CUDA kernel of the port against its plain version, on an NVIDIA GPU:
the one card check of every kernel.

Marked ``cuda`` and skipped without a GPU.  Imports no JAX, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

A kernel is held at the main paths' own calls (batch 64 serving, 128 views
training, at the shapes of each configuration that launches it) and at the
edges of its tiles, in fp32 and bf16, within one tolerance of its own, and
every check also rejects a control, the same comparison with a fault planted
in the kernel's result or in the plain version's inputs (a bias or mask
dropped, padded keys left unmasked, dK zeroed, half a gradient, an iteration
short ...).  Two runs give the same bits, and each call counts one launch.
Each wrapper's check at one call, its cases and its tolerance (the ``TOL_*``
constants, each beside its reason) are ``kernel_checks.py``'s, which
``chip_smoke.py`` runs at the main paths' calls too; the tests here run it at
every case, and hold the edges of the Hopper tiles.  ``test_cuda_kernels_
hold_wgmma`` reads every Hopper library's SASS: its bf16 kernels issue HGMMA,
its CUDA-core bodies none.  ``kernel_turns.py`` times the kernels against
another checkout.

Window attention (1, 1b) at the four Swin-Base stages (batch 64 forward, 128
backward), Swin-Large/1280's padded canvases with the pad sentinel in the mask
(control: the sentinel removed) and windows of 2 to 8; packed attention (3,
3b) at the ViT calls and a Swin packed shape, and at the edges of the Hopper
tiles; q-tiled attention (6, 6b) at ViT-Base/448's 785 and ViT-Large/512's
1025 tokens (control: every query attends the first 64 keys only); their
log-sum-exp within ``TOL_LSE`` of its largest.  GPF (2, 2b) at every main
path's [64, N, D] and at token counts and widths around its 64- and 128-token
tiles; one tensor twice, its two gradients summed by autograd.  Newton-Schulz
(5, 5′, 5″) on full-rank M and on the moment head's M at its calls; four
iterations instead of five fail.  The fused attention half (4, 4b) at
Swin-Base's stages 0 and 1 and at the edges of its tiles.  The token-subspace
iSQRT (7, no TPU kernel) against an fp64 witness: its error at most
``TOL_SI_F32_RATIO`` times the plain fp32 route's (``isqrt_cov_subspace`` on
the CUDA cores, TF32 off), and in bf16, whose rounding hides that norm, also
element by element (``TOL_SI_BF16``); the kernel with each fp32 operand's lo
term dropped fails both at five iterations.  EVA's SwiGLU glue (8, no TPU
kernel) at EVA-02-L's serving shape, a ragged row count and the micro EVA's
341 -> 344 (``TOL_SWIGLU``; the padded columns exactly 0; controls: gate and
value swapped, the bias left out), and its SiLU table against PyTorch's bf16
SiLU bit for bit.

The data and engine layers on the card: ``DevicePrefetcher`` gives the
batches inline copies give, bit for bit, and a checkpoint GPU -> CPU -> GPU
keeps the model's and the optimizer's state bits.  The spans
(``utils/trace.py``): under the profiler, a train step and a serving call of
the Swin-Base/224 flagship and of ViT-L/16 at 448 with the multi-scale head,
and a serving call of EVA-02-L/14 at 448, record one
``emct.kernel.<wrapper>`` range for every count of ``<wrapper>.launches``,
the backward's launches from the autograd thread included.
"""

import numpy as np
import pytest
import torch

import kernel_checks as kc
from ego_moment_cle_vit_tpu_torch.kernels import _build
from ego_moment_cle_vit_tpu_torch.kernels import attn_half as tah
from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as tfa
from ego_moment_cle_vit_tpu_torch.kernels import gpf as tgpf
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as tns
from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as tpa
from ego_moment_cle_vit_tpu_torch.kernels import subspace_isqrt as tsi
from ego_moment_cle_vit_tpu_torch.kernels import swiglu_norm as tsn
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as twa
from ego_moment_cle_vit_tpu_torch.models.swin import _attn_mask
from ego_moment_cle_vit_tpu_torch.ops.moments import isqrt_cov_subspace

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hp, c, heads, shifted", [(14, 128, 4, True), (7, 256, 8, False)])
def test_cuda_window_attention_matches_plain(cuda_device, dtype, hp, c, heads, shifted):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(2, hp, hp, 3 * c, generator=g, device=cuda_device).to(dtype)
    bias = kc.window_bias(g, cuda_device, heads)
    mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, kc.WS, 3), device=cuda_device)
            if shifted else None)
    args = (qkv, bias, mask, heads, kc.WS, (c // heads) ** -0.5)
    before = twa.window_attention_fwd.launches
    out = twa.window_attention_fwd(*args)
    assert twa.window_attention_fwd.launches == before + 1
    ref = twa.window_attention_plain(*args)
    assert out.dtype == dtype and kc.close(out, ref, *kc.TOL_ATTENTION[dtype])
    # the check has power: the plain version without its bias falls outside it
    ctrl = twa.window_attention_plain(qkv, torch.zeros_like(bias), *args[2:])
    assert not kc.close(ctrl, ref, *kc.TOL_ATTENTION[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("b, n, d", kc.GPF)
def test_cuda_gpf_matches_plain(cuda_device, dtype, similarity, b, n, d):
    kc.check_gpf_fwd(cuda_device, dtype, similarity, b, n, d)


@pytest.mark.cuda
def test_cuda_a_launch_is_a_new_threads_first_cuda_work(cuda_device):
    """A thread whose first CUDA work is a launch (autograd's device thread
    when a kernel's backward runs first) gets the main thread's result: the
    bf16 libraries encode TMA maps with libcuda, which needs the device's
    context current there (``_build.bind_context``)."""
    import threading

    g = torch.Generator(device=cuda_device).manual_seed(2)
    ta = torch.randn(4, 49, 256, generator=g, device=cuda_device).to(torch.bfloat16)
    c = torch.rand(3, 3, generator=g, device=cuda_device) + 0.05
    cot = torch.randn(4, 49, 49, generator=g, device=cuda_device)
    want = tgpf.gpf_bwd(ta, ta, c, cot, "dot")
    got = []
    t = threading.Thread(target=lambda: got.append(tgpf.gpf_bwd(ta, ta, c, cot, "dot")))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert got and all(torch.equal(a, b) for a, b in zip(got[0], want))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda_device):
    qkv = torch.zeros(1, 7, 7, 3 * 96, device=cuda_device)  # head dim 48 is not compiled
    bias = torch.zeros(2, 49, 49, device=cuda_device)
    with pytest.raises(ValueError, match="C / heads"):
        twa.window_attention_fwd(qkv, bias, None, 2, 7, 1.0)
    t = torch.zeros(1, 49, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        tgpf.gpf_fwd(t, t, torch.ones(3, 3, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, hp, c, heads, shifted", [(5, 14, 128, 4, True),
                                                      (3, 7, 256, 8, False)])
def test_cuda_window_attention_bwd_matches_plain(cuda_device, dtype, b, hp, c, heads, shifted):
    atol, rtol, btol = kc.TOL_ATTENTION_BWD[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(b, hp, hp, 3 * c, generator=g, device=cuda_device).to(dtype)
    dout = torch.randn(b, hp, hp, c, generator=g, device=cuda_device).to(dtype)
    bias = kc.window_bias(g, cuda_device, heads)
    mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, kc.WS, 3), device=cuda_device)
            if shifted else None)
    args = (qkv, bias, mask, dout, heads, kc.WS, (c // heads) ** -0.5)
    before = twa.window_attention_bwd.launches
    dqkv, dbias = twa.window_attention_bwd(*args)
    assert twa.window_attention_bwd.launches == before + 1
    ref_dqkv, ref_dbias = twa.window_attention_bwd_plain(*args)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert kc.close(dqkv, ref_dqkv, atol, rtol)
    assert (dbias - ref_dbias).abs().max().item() <= btol * ref_dbias.abs().max().item()
    # controls: dK zeroed, and the bias gradient dropped, both fall outside
    ctrl = ref_dqkv.clone()
    ctrl[..., c:2 * c] = 0
    assert not kc.close(ctrl, ref_dqkv, atol, rtol)
    assert ref_dbias.abs().max().item() > btol * ref_dbias.abs().max().item()
    # and the Function routes autograd through the same kernels
    q2 = qkv.clone().requires_grad_()
    b2 = bias.clone().requires_grad_()
    twa.window_attention(q2, b2, mask, heads, kc.WS, args[-1]).backward(dout)
    assert torch.equal(q2.grad, dqkv) and torch.equal(b2.grad, dbias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("b, n, d", kc.GPF_BWD)
def test_cuda_gpf_bwd_matches_plain(cuda_device, dtype, similarity, b, n, d):
    kc.check_gpf_bwd(cuda_device, dtype, similarity, b, n, d)


# The Hopper backward of kernel 2b (csrc/gpf_bwd_sm90.cuh, the bf16 dX on
# wgmma from W split in two bf16 terms, and gpf_bwd.cu's wgmma Gram) at the
# edges of its tiles: one token, one under, at and over a 64-token tile, the
# Swin, ViT/224, ViT/448 and ViT-Large/512 token counts and 785; widths of
# one 64-feature box, one TMA cannot take (100), ViT-Base's and ViT-Large's.
# fp32 (the CUDA-core bodies) at the same shapes.
GPF_BWD_N = (1, 49, 63, 64, 65, 196, 784, 785, 1024)
GPF_BWD_D = (64, 100, 768, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("d", GPF_BWD_D)
@pytest.mark.parametrize("n", GPF_BWD_N)
def test_cuda_gpf_bwd_sm90_edges(cuda_device, n, d, similarity, dtype):
    """2b against its plain version, two distinct token sets and one tensor
    twice, the cotangent off the kink: within TOL_GPF_BWD and TOL_GPF_DC, one
    launch a call, the same bits twice.  With one token under cosine the
    exact token gradients are zero (a single token's cosine Gram is 1
    whatever the token), so both sides hold rounding noise and are held to
    1e-5 absolute there."""
    _gpf_bwd_edge(cuda_device, n, d, similarity, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("n, d", [(1600, 1536), (1600, 100)])
def test_cuda_gpf_bwd_sm90_swin_large(cuda_device, n, d, similarity, dtype):
    """2b as above at the largest token count the wrappers admit
    (``gpf.MAX_TOKENS``, Swin-Large/1280's 1600 tokens) at its width, 1536,
    and at a width TMA cannot take."""
    _gpf_bwd_edge(cuda_device, n, d, similarity, dtype)


def _gpf_bwd_edge(cuda_device, n, d, similarity, dtype):
    tol = kc.TOL_GPF_BWD[dtype]
    b = 2 if n <= 196 else 1
    g = torch.Generator(device=cuda_device).manual_seed(n * 7 + d)
    ta = torch.randn(b, n, d, generator=g, device=cuda_device).to(dtype)
    tp = torch.randn(b, n, d, generator=g, device=cuda_device).to(dtype)
    c = torch.rand(3, 3, generator=g, device=cuda_device) + 0.05
    cot = torch.randn(b, n, n, generator=g, device=cuda_device)
    zero_exact = n == 1 and similarity == "cosine"

    def rows_close(out, ref):
        if zero_exact:
            return bool((out.float().abs() <= 1e-5).all() and (ref.float().abs() <= 1e-5).all())
        scale = ref.float().abs().amax(dim=-1, keepdim=True)
        return bool(((out.float() - ref.float()).abs() <= tol * scale).all())

    for pos in (tp, ta):
        cot_pos = kc.off_the_kink(ta, pos, c, cot, similarity)
        before = tgpf.gpf_bwd.launches
        dta, dtp, dc = tgpf.gpf_bwd(ta, pos, c, cot_pos, similarity)
        assert tgpf.gpf_bwd.launches == before + 1
        rta, rtp, rdc = tgpf.gpf_bwd_plain(ta, pos, c, cot_pos, similarity)
        assert dta.dtype == dtype and dtp.shape == (b, n, d)
        assert rows_close(dta, rta) and rows_close(dtp, rtp)
        assert ((dc - rdc).abs() <= kc.TOL_GPF_DC * rdc.abs().amax()).all()
        if not zero_exact:  # a control: half the gradient
            assert not rows_close(0.5 * rta.float(), rta)
        again = tgpf.gpf_bwd(ta, pos, c, cot_pos, similarity)
        assert all(torch.equal(x, y) for x, y in zip(again, (dta, dtp, dc)))


def _sass_functions(path):
    """{kernel's mangled name: its SASS} of a built library (cuobjdump)."""
    import shutil
    import subprocess
    from pathlib import Path

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


# (library, its kernels that must issue HGMMA, its kernels that must not), each
# by a fragment of the mangled name: every Hopper library's bf16 kernels on
# wgmma, and its CUDA-core bodies (fp32, and the small elementwise kernels)
WGMMA = [
    ("window_attention_fwd", ("window_attention_fwd_sm90",), ("window_attention_fwd_f32",)),
    ("window_attention_bwd", ("window_attention_bwd_sm90",), ("window_attention_bwd_f32",)),
    ("gpf_fwd", ("gpf_fwd_sm90",), ("gpf_fwd_kernel",)),
    ("gpf_bwd", ("gpf_bwd_w_sm90", "gpf_sm909dx_kernel"),
     ("gpf_bwd_w_kernel", "gpf_fp329dx_kernel")),
    *((lib, ("18attention_fwd_sm90",), ("8fp32_fwd",))
      for lib in ("packed_attention_fwd", "flash_attention_fwd")),
    *((lib, ("attention_bwd_dq_sm90", "attention_bwd_dkv_sm90"), ("8fp32_bwd",))
      for lib in ("packed_attention_bwd", "flash_attention_bwd")),
    *((lib, ("gemm_sm90_kernel",), ("init_kernel", "finish_kernel"))
      for lib in ("newton_schulz_bf16", "newton_schulz_bf16_streamed")),
    ("attn_half_fwd", ("attn_half_fwd_sm90",), ("attn_half_fwd_f32",)),
    ("attn_half_bwd", ("ah_bwd_qkv_do", "ah_bwd_dx", "ah_bwd_wgrad"),
     ("attn_half_bwd_attention", "attn_half_bwd_dx", "attn_half_bwd_wgrad",
      "attn_half_bwd_layer_norm")),
    ("subspace_isqrt", ("product_kernel",), ("trace_kernel", "split_kernel", "eye_kernel")),
    ("newton_schulz", ("ns_gemm",), ("ns_trace", "ns_init")),
]


@pytest.mark.cuda
@pytest.mark.parametrize("library, wgmma, cuda_cores", WGMMA)
def test_cuda_kernels_hold_wgmma(cuda_device, library, wgmma, cuda_cores):
    """Every kernel of ``library`` named by a fragment of ``wgmma`` issues
    HGMMA, every one named by a fragment of ``cuda_cores`` none, and each
    fragment names at least one kernel."""
    fns = _sass_functions(_build.build()[library])  # every library at once, the first time
    has = {name: "HGMMA" in sass for name, sass in fns.items()}
    for keys, want in ((wgmma, True), (cuda_cores, False)):
        for key in keys:
            hits = [h for name, h in has.items() if key in name]
            assert hits and all(h == want for h in hits), (key, has)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, w, t, c, heads, hb, wm", kc.PACKED)
def test_cuda_packed_attention_matches_plain(cuda_device, dtype, b, w, t, c, heads, hb, wm):
    kc.check_packed_attention_fwd(cuda_device, dtype, b, w, t, c, heads, hb, wm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, w, t, c, heads, hb, wm", kc.PACKED)
def test_cuda_packed_attention_bwd_matches_plain(cuda_device, dtype, b, w, t, c, heads, hb, wm):
    kc.check_packed_attention_bwd(cuda_device, dtype, b, w, t, c, heads, hb, wm)


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
    lse within TOL_ATTENTION_BWD; at one token the exact dbias is zero (P =
    1, ds = dp - delta = 0), so both sides hold rounding noise only and dbias
    is held to 1e-4 absolute there.  Two runs give the same bits; dK zeroed
    falls outside."""
    atol, rtol, btol = kc.TOL_ATTENTION_BWD[torch.bfloat16]
    w = 2 if extras else 1
    qkv, dout, bias, mask = kc.packed_inputs(cuda_device, torch.bfloat16, 3, w, t, c, heads,
                                    heads if extras else None, w if extras else None)
    out, lse = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=True)
    dqkv, dbias = tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads)
    ref, ref_dbias = tpa.packed_attention_bwd_plain(qkv, bias, mask, out, lse, dout, heads)
    assert torch.isfinite(dqkv.float()).all() and kc.close(dqkv, ref, atol, rtol)
    ctrl = ref.clone()
    ctrl[..., c:2 * c] = 0
    assert t == 1 or not kc.close(ctrl, ref, atol, rtol)
    if extras:
        err = (dbias - ref_dbias).abs().max().item()
        assert err <= (1e-4 if t == 1 else btol * ref_dbias.abs().max().item())
    again, dbias_again = tpa.packed_attention_bwd(qkv, bias, mask, out, lse, dout, heads)
    assert torch.equal(again, dqkv) and (dbias is None or torch.equal(dbias_again, dbias))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [257, 785, 1025])
def test_cuda_flash_attention_bwd_sm90_long(cuda_device, t):
    """bf16 6b past the packed kernel's 256 tokens, at ViT-Base/448's and
    ViT-Large/512's lengths, two heads of 64: within TOL_TILED_BWD of the
    plain version, the same bits twice, dK zeroed outside."""
    atol, rtol = kc.TOL_TILED_BWD[torch.bfloat16]
    g = torch.Generator(device=cuda_device).manual_seed(9)
    qkv = torch.randn(2, t, 3 * 128, generator=g, device=cuda_device).to(torch.bfloat16)
    dout = torch.randn(2, t, 128, generator=g, device=cuda_device).to(torch.bfloat16)
    out, lse = tfa.flash_attention_tiled_fwd(qkv, 2)
    dqkv = tfa.flash_attention_tiled_bwd(qkv, out, lse, dout, 2)
    ref = tfa.flash_attention_tiled_bwd_plain(qkv, dout, 2)
    assert kc.close(dqkv, ref, atol, rtol)
    ctrl = ref.clone()
    ctrl[..., 128:256] = 0
    assert not kc.close(ctrl, ref, atol, rtol)
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
    """bf16 kernel 3 against its plain version per element within
    TOL_ATTENTION, its lse within TOL_LSE of the largest plain log-sum-exp;
    two runs give the same bits.  A control: the keys padded to 64 and left
    unmasked fall outside the lse check, and outside the output check too
    unless a single key is padded (one zero key among 64 or more moves an
    output by less than its tolerance)."""
    atol, rtol = kc.TOL_ATTENTION[torch.bfloat16]
    w = 2 if extras else 1
    qkv, _, bias, mask = kc.packed_inputs(cuda_device, torch.bfloat16, 3, w, t, c, heads,
                                 heads if extras else None, w if extras else None)
    res = tpa.packed_attention_fwd(qkv, bias, mask, heads, return_lse=with_lse)
    out, lse = res if with_lse else (res, None)
    ref, ref_lse = tpa.packed_attention_plain(qkv, bias, mask, heads, return_lse=True)
    assert out.shape == (3, w, t, c) and torch.isfinite(out.float()).all()
    assert kc.close(out, ref, atol, rtol)
    if with_lse:
        assert lse.shape == (3 * w, heads, t)
        assert (lse - ref_lse).abs().max().item() <= kc.TOL_LSE * ref_lse.abs().max().item()
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
        assert lse_off > kc.TOL_LSE * ref_lse.abs().max().item()
        assert pad == 1 or not kc.close(ctrl[:, :, :t], ref, atol, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [257, 785, 800, 1025])
def test_cuda_flash_attention_fwd_sm90_long(cuda_device, t):
    """bf16 kernel 6 past the packed kernel's 256 tokens (785 at ViT-Base/448,
    800 a whole last key tile, 1025 at ViT-Large/512), two heads of 64:
    within TOL_TILED of the plain version, lse within TOL_LSE of the largest
    plain log-sum-exp, the same bits twice, the keys padded to 64 and left
    unmasked outside."""
    atol, rtol = kc.TOL_TILED[torch.bfloat16]
    g = torch.Generator(device=cuda_device).manual_seed(10)
    qkv = torch.randn(2, t, 3 * 128, generator=g, device=cuda_device).to(torch.bfloat16)
    out, lse = tfa.flash_attention_tiled_fwd(qkv, 2)
    ref, ref_lse = tfa.flash_attention_tiled_plain(qkv, 2)
    assert kc.close(out, ref, atol, rtol)
    assert (lse - ref_lse).abs().max().item() <= kc.TOL_LSE * ref_lse.abs().max().item()
    again, lse_again = tfa.flash_attention_tiled_fwd(qkv, 2)
    assert torch.equal(again, out) and torch.equal(lse_again, lse)
    padded = torch.nn.functional.pad(qkv, (0, 0, 0, -(-t // 64) * 64 - t))
    assert not kc.close(tfa.flash_attention_tiled_plain(padded, 2)[0][:, :t], ref, atol, rtol)


@pytest.mark.cuda
def test_cuda_attention_fwd_sm90_two_blocks_an_sm(cuda_device):
    """The design's occupancy holds: the bf16 forward fits 128 registers a
    thread, and two blocks (two consumer warpgroups each) share an SM."""
    occ = tfa.fwd_occupancy()
    assert occ["registers"] <= 128 and occ["blocks_per_sm"] >= 2, occ


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, t, c, heads", kc.FLASH)
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, b, t, c, heads):
    kc.check_flash_attention_tiled_fwd(cuda_device, dtype, b, t, c, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, t, c, heads", kc.FLASH)
def test_cuda_flash_attention_bwd_matches_plain(cuda_device, dtype, b, t, c, heads):
    kc.check_flash_attention_tiled_bwd(cuda_device, dtype, b, t, c, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, n, d", kc.NS)
def test_cuda_newton_schulz_matches_plain(cuda_device, dtype, b, n, d):
    kc.check_newton_schulz_isqrt_fp32_fwd(cuda_device, dtype, b, n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("k, b, d", [(0, 3, 64), (1, 3, 99), (2, 3, 100), (5, 33, 99),
                                     (5, 2, 825), (3, 1, 8)])
def test_cuda_newton_schulz_edges(cuda_device, k, b, d):
    """Kernel 5 at k = 0 and 1 (no product), 2 (no Z update), at odd widths
    (output rows off the pair grain, a plane's pad column), the dispatch's
    widest (825) and a width under one tile's rows, and at 33 images (two
    passes, the second short): within TOL_NS of the plain fp32 route, and for
    k >= 2 within the fp64 witness's bar; one launch a call."""
    m = kc.ns_inputs(torch.Generator(device=cuda_device).manual_seed(7), torch.float32, b,
                     None, d)
    before = tns.newton_schulz_isqrt_fp32_fwd.launches
    out = tns.newton_schulz_isqrt_fp32_fwd(m, k, 1e-5)
    assert tns.newton_schulz_isqrt_fp32_fwd.launches == before + 1
    assert kc.ns_close(out, tns.newton_schulz_isqrt_plain(m, k, 1e-5),
                       *kc.TOL_NS[torch.float32])
    if k >= 2:
        witness, bar = kc.ns_witness_bar(m, k)
        assert kc.ns_witness_error(out, witness) <= bar


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant, b, n, d", kc.NS_BF16)
def test_cuda_newton_schulz_bf16_matches_plain(cuda_device, dtype, variant, b, n, d):
    kc.check_newton_schulz_bf16(cuda_device, dtype, variant, b, n, d)


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, d", NS_STREAMED)
def test_cuda_newton_schulz_streamed_sm90(cuda_device, b, d, dtype):
    """5″ against its plain version within TOL_NS_BF16 (both sides round at
    the same points); four iterations fail that; two runs give the same
    bits; one step, which runs no product, the plain version's bits."""
    rtol, atol = kc.TOL_NS_BF16["full_rank"]
    g = torch.Generator(device=cuda_device).manual_seed(11 + d)
    z = torch.randn(b, d + 64, d, generator=g, device=cuda_device)
    m = (z.transpose(1, 2) @ z / (d + 64)).to(dtype)

    def close(out, ref):
        ref = ref.float()
        return bool(((out.float() - ref).abs() <= rtol * ref.abs() + atol * ref.abs().max()).all())

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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("d", NS_BF16_SM90)
def test_cuda_newton_schulz_bf16_sm90(cuda_device, b, d, dtype):
    """5′ against its plain version within TOL_NS_BF16 (both sides round at
    the same points); four iterations fail that; two runs give the same
    bits; one step, which runs no product, the plain version's bits."""
    rtol, atol = kc.TOL_NS_BF16["full_rank"]
    g = torch.Generator(device=cuda_device).manual_seed(13 + d + b)
    z = torch.randn(b, d + 64, d, generator=g, device=cuda_device)
    m = (z.transpose(1, 2) @ z / (d + 64)).to(dtype)

    def close(out, ref):
        ref = ref.float()
        return bool(((out.float() - ref).abs() <= rtol * ref.abs() + atol * ref.abs().max()).all())

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, hp, c, heads, shifted", kc.ATTN_HALF)
def test_cuda_attn_half_matches_plain(cuda_device, dtype, b, hp, c, heads, shifted):
    kc.check_attn_half_fwd(cuda_device, dtype, b, hp, c, heads, shifted)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, hp, c, heads, shifted", kc.ATTN_HALF)
def test_cuda_attn_half_bwd_matches_plain(cuda_device, dtype, b, hp, c, heads, shifted):
    kc.check_attn_half_bwd(cuda_device, dtype, b, hp, c, heads, shifted)


@pytest.mark.cuda
def test_cuda_attn_half_rejects_bad_inputs(cuda_device):
    args, _ = kc.attn_half_inputs(cuda_device, torch.float32, 1, 7, 128, 4, False)
    with pytest.raises(ValueError, match="C / heads"):
        tah.attn_half_fwd(*args, 2, kc.WS)  # head dim 64 is not compiled
    with pytest.raises(ValueError, match="wqkv must be"):
        tah.attn_half_fwd(args[0], args[1], args[2], args[3].bfloat16(), *args[4:], 4, kc.WS)
    with pytest.raises(TypeError, match="not supported"):
        tah.attn_half_fwd(args[0].double(), *args[1:3], *(t.double() for t in args[3:7]),
                          *args[7:], 4, kc.WS)


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
    """Kernel 4 in bf16 within TOL_AH of its plain version; the bias omitted
    and the residual dropped fall outside; one launch a call; the same bits
    twice."""
    if ws == kc.WS:
        args, _ = kc.attn_half_inputs(cuda_device, torch.bfloat16, b, hp, c, heads, shifted)
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
    atol, rtol = kc.TOL_AH[torch.bfloat16]
    before = tah.attn_half_fwd.launches
    out = tah.attn_half_fwd(*args, heads, ws)
    assert tah.attn_half_fwd.launches == before + 1
    ref = tah.attn_half_plain(*args, heads, ws)
    assert out.dtype == torch.bfloat16 and kc.close(out, ref, atol, rtol)
    no_bias = args[:7] + (torch.zeros_like(args[7]), args[8])
    assert not kc.close(tah.attn_half_plain(*no_bias, heads, ws), ref, atol, rtol)
    assert not kc.close(ref.float() - args[0].float(), ref, atol, rtol)
    assert torch.equal(tah.attn_half_fwd(*args, heads, ws), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("b, hp, c, heads, ws", kc.WA_BWD)
def test_cuda_window_attention_bwd_sm90_shapes(cuda_device, dtype, b, hp, c, heads, ws, shifted):
    kc.check_window_attention_bwd(cuda_device, dtype, b, hp, c, heads, ws, shifted)


# the fused attention half's backward (4b) where its tiles end: token counts
# that are not multiples of 128 (441, 588, 1225) at both widths
ATTN_HALF_SM90 = [(1, 21, 128, 4), (3, 14, 256, 8), (1, 35, 256, 8), (2, 28, 128, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("b, hp, c, heads", ATTN_HALF_SM90)
def test_cuda_attn_half_bwd_sm90_shapes(cuda_device, dtype, b, hp, c, heads, shifted):
    atol, rtol, gtol = kc.TOL_AH_BWD[dtype]
    args, dy = kc.attn_half_inputs(cuda_device, dtype, b, hp, c, heads, shifted)
    got = tah.attn_half_bwd(*args, dy, heads, kc.WS)
    ref = tah.attn_half_bwd_plain(*args, dy, heads, kc.WS)
    assert kc.close(got[0], ref[0], atol, rtol)
    for a, r in zip(got[1:], ref[1:]):
        assert (a - r).abs().max().item() <= gtol * r.abs().max().item()
    assert all(torch.equal(a, r) for a, r in zip(tah.attn_half_bwd(*args, dy, heads, kc.WS), got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("b, hp, c, heads, ws", kc.WA_FWD)
def test_cuda_window_attention_fwd_sm90_shapes(cuda_device, dtype, b, hp, c, heads, ws, shifted):
    kc.check_window_attention_fwd(cuda_device, dtype, b, hp, c, heads, ws, shifted)


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
    with two: each entry within TOL_GPF of ``gpf_error_scale``, the output
    exactly symmetric, a zeroed off-diagonal falling
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
        assert ((out - ref).abs() <= kc.TOL_GPF * scale).all()
        assert torch.equal(out, out.transpose(1, 2))
        if n > 1:
            zeroed = out * torch.eye(n, device=cuda_device)
            assert not ((zeroed - ref).abs() <= kc.TOL_GPF * scale).all()
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


KERNEL_WRAPPERS = tuple(_build.wrappers().values())


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


# the benchmark's configurations, with the launches a step and a call
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
    # served only: no cell trains EVA or DINOv2
    "eva02L-448": (_flagship_config("eva02_large_patch14_448", 448, 600), None,
                   {"flash_attention_tiled_fwd": 24, "gpf_fwd": 1,
                    "newton_schulz_isqrt_bf16_fwd": 1, "swiglu_norm_fwd": 24}),
    "dinov2g-518": (_flagship_config("vit_giant_patch14_reg4_dinov2", 518, 592), None,
                    {"flash_attention_tiled_fwd": 40, "gpf_fwd": 1, "subspace_isqrt_fwd": 1}),
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("b, n, d", kc.SUBSPACE)
def test_cuda_subspace_isqrt_meets_the_fp64_bar(cuda_device, b, n, d, k, dtype):
    kc.check_subspace_isqrt_fwd(cuda_device, dtype, b, n, d, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 2])
def test_cuda_subspace_isqrt_closed_form_iterations(cuda_device, k):
    """k = 0 (I / sqrt(t)), 1 (no product before the last) and 2 (S X and S H
    only) against the fp64 witness, with the fp32 bar."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    centered, weighted = kc.subspace_inputs(g, 3, 130, 256, torch.float32)
    out = tsi.subspace_isqrt_fwd(centered, weighted, k, 1e-5)
    witness = isqrt_cov_subspace(centered.double(), weighted.double(), k, 1e-5)
    plain = isqrt_cov_subspace(centered, weighted, k, 1e-5)
    if k == 0:
        torch.testing.assert_close(out.double(), witness, rtol=1e-6, atol=0)
        return
    err = kc.witness_error(out, witness, centered, weighted, k)
    assert err <= kc.TOL_SI_F32_RATIO * kc.witness_error(plain, witness, centered, weighted, k)


@pytest.mark.cuda
def test_cuda_subspace_isqrt_counts_one_launch_and_span(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    centered, weighted = kc.subspace_inputs(g, 2, 49, 128, torch.bfloat16)
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
@pytest.mark.parametrize("rows, width", kc.SWIGLU)
def test_cuda_swiglu_norm_matches_plain(cuda_device, rows, width):
    kc.check_swiglu_norm_fwd(cuda_device, rows, width)


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
    g, u, w, b = kc.swiglu_inputs(cuda_device, 64, 2730)
    tsn.swiglu_norm_fwd(g, u, w, b, 2730, 1e-6)  # built and loaded
    spans, launched = _kernel_spans_and_launches(
        lambda: tsn.swiglu_norm_fwd(g, u, w, b, 2730, 1e-6))
    assert launched == {"swiglu_norm_fwd": 1}
    assert spans == launched


@pytest.mark.cuda
def test_cuda_swiglu_norm_rejects_bad_inputs(cuda_device):
    g, u, w, b = kc.swiglu_inputs(cuda_device, 16, 2730)
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
