"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``cuda`` and skipped without a GPU.  Imports no JAX, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: window attention fp32 1e-4 absolute (sum order); bf16 3.2e-2,
two bf16 ulps at |out| < 4 (the kernel rounds the probabilities to bf16
before P v, the plain version does not).  GPF: each entry within 2e-4 of
``gpf_error_scale``, its own size, and a zeroed off-diagonal fails that.
"""

import pytest
import torch

from ego_moment_cle_vit_tpu_torch.kernels import gpf as tgpf
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as twa
from ego_moment_cle_vit_tpu_torch.models.swin import _attn_mask, _relative_position_index

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
def test_cuda_gpf_matches_plain(cuda_device, dtype, similarity):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ta = torch.randn(4, 49, 256, generator=g, device=cuda_device).to(dtype)
    tp = torch.randn(4, 49, 256, generator=g, device=cuda_device).to(dtype)
    c = torch.rand(3, 3, generator=g, device=cuda_device)
    for pos in (ta, tp):
        out = tgpf.gpf_fwd(ta, pos, c, similarity)
        ref = tgpf.gpf_plain(ta, pos, c, similarity)
        scale = tgpf.gpf_error_scale(ta, pos, c, similarity)
        assert out.dtype == torch.float32
        assert ((out - ref).abs() <= 2e-4 * scale).all()
        zeroed = out * torch.eye(49, device=cuda_device)
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
