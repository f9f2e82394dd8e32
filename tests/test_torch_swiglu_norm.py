"""EVA's SwiGLU glue (``kernels/swiglu_norm.py``) on the CPU: the wrapper's
plain version against the composition the SwiGLU ran before it had one, the
SwiGLU's dispatch by grad mode, and the checks that guard the kernel.  The
kernel itself is held on the card (``tests/test_torch_cuda.py -k swiglu``).

* ``swiglu_norm_fwd`` on CPU tensors is ``F.pad(LayerNorm(silu(g) *
  u)[..., :W], (0, P - W))`` with the port's LayerNorm module, bit for bit, in
  bf16 and fp32 at W = 341 (the micro EVA, P = 344) and 2730 (EVA-02-L, P =
  2736), whatever the padded columns of g and u hold; the padded columns of
  the result are exactly 0, and no launch is counted.
* A bf16 ``SwiGLU.padded`` calls the wrapper where no gradient is wanted
  (``no_grad``, ``inference_mode``, frozen parameters) and keeps the
  composition under autograd, with the values and every parameter's
  gradient of the parent's ``padded``, bit for bit.
* Malformed inputs raise before anything is launched: fp32 or other dtypes,
  widths the kernel does not take, shapes that disagree, non-contiguous
  tensors, and, for well-formed inputs, any device but a CUDA one.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from ego_moment_cle_vit_tpu_torch.kernels import swiglu_norm as sn
from ego_moment_cle_vit_tpu_torch.models import eva
from ego_moment_cle_vit_tpu_torch.models.layers import LayerNorm

torch.set_num_threads(1)

EPS = 1e-6


def glue_inputs(rows: int, width: int, dtype, seed: int = 0):
    """g and u ``[2, rows, P]`` (P = width padded to a multiple of 8, the
    padded columns drawn too), the LayerNorm with random weight and bias."""
    padded = width + (-width % eva.ALIGN)
    gen = torch.Generator().manual_seed(seed)
    g = (1.5 * torch.randn(2, rows, padded, generator=gen)).to(dtype)
    u = torch.randn(2, rows, padded, generator=gen).to(dtype)
    norm = LayerNorm(width, eps=EPS)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(width, generator=gen))
        norm.bias.copy_(0.3 * torch.randn(width, generator=gen))
    return g, u, norm


def composition(g, u, norm, width):
    """The SwiGLU's glue as it was composed before the wrapper."""
    h = norm((F.silu(g) * u)[..., :width])
    pad = g.shape[-1] - width
    return F.pad(h, (0, pad)) if pad else h


@pytest.mark.parametrize("width", [341, 2730])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_wrapper_is_the_composition(dtype, width):
    g, u, norm = glue_inputs(5, width, dtype)
    before = sn.swiglu_norm_fwd.launches
    with torch.no_grad():
        out = sn.swiglu_norm_fwd(g, u, norm.weight, norm.bias, width, EPS)
        want = composition(g, u, norm, width)
    assert sn.swiglu_norm_fwd.launches == before
    assert out.dtype == dtype and out.shape == g.shape
    assert torch.equal(out, want)
    assert torch.equal(out[..., width:], torch.zeros_like(out[..., width:]))
    # the padded columns of g and u are never read
    g[..., width:], u[..., width:] = 7.0, -3.0
    with torch.no_grad():
        assert torch.equal(sn.swiglu_norm_fwd(g, u, norm.weight, norm.bias, width, EPS), out)


def parent_padded(mlp: eva.SwiGLU, x: torch.Tensor, pad: int) -> torch.Tensor:
    """``SwiGLU.padded`` as it was before the wrapper."""
    width = mlp.norm.weight.shape[0]
    h = F.silu(eva._widened(mlp.fc1_g, x, rows=pad)) * eva._widened(mlp.fc1_x, x, rows=pad)
    h = mlp.norm(h[..., :width])
    return eva._widened(mlp.fc2, F.pad(h, (0, pad)) if pad else h, cols=pad)


def swiglu(width: int, dtype):
    mlp = eva.SwiGLU(64, width, EPS, dtype, "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    x = torch.randn(2, 5, 64, generator=gen).to(dtype)
    return mlp, x


MODES = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
         "frozen": contextlib.nullcontext, "grad": contextlib.nullcontext}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("width", [341, 2730])
def test_padded_routes_to_the_wrapper_only_without_grad(monkeypatch, width, mode):
    mlp, x = swiglu(width, torch.bfloat16)
    if mode == "frozen":
        mlp.requires_grad_(False)
    calls = []
    wrapper = sn.swiglu_norm_fwd

    def spy(*args):
        calls.append(args[0].shape)
        return wrapper(*args)
    monkeypatch.setattr(sn, "swiglu_norm_fwd", spy)
    pad = -width % eva.ALIGN
    outs = {}
    for name, fn in (("wrapper", mlp.padded), ("parent", lambda x, p: parent_padded(mlp, x, p))):
        with MODES[mode]():
            for p in (0, pad):
                mlp.zero_grad()
                out = fn(x, p)
                grads = None
                if out.requires_grad:
                    out.float().pow(2).sum().backward()
                    grads = [q.grad.clone() for q in mlp.parameters()]
                outs[name, p] = (out.detach(), grads)
    assert len(calls) == (0 if mode == "grad" else 2)
    for p in (0, pad):
        (got, g_got), (want, g_want) = outs["wrapper", p], outs["parent", p]
        assert torch.equal(got, want)
        assert (g_got is None) == (g_want is None) == (mode != "grad")
        for a, b in zip(g_got or [], g_want or []):
            assert torch.equal(a, b)


def _malformed(kind: str):
    """(g, u, weight, bias, width) malformed in one way, and the error."""
    g, u, norm = glue_inputs(3, 2730, torch.bfloat16)
    w, b, width = norm.weight.detach(), norm.bias.detach(), 2730
    if kind == "fp32_input":
        return (g.float(), u.float(), w, b, width), TypeError
    if kind == "bf16_params":
        return (g, u, w.bfloat16(), b.bfloat16(), width), TypeError
    if kind == "width_past_row":
        return (g, u, torch.ones(2737), torch.zeros(2737), 2737), ValueError
    if kind == "row_not_multiple_of_8":
        return (g[..., :2730].contiguous(), u[..., :2730].contiguous(), w, b, width), ValueError
    if kind == "row_too_wide":
        wide = torch.zeros(2, 3, sn.MAX_WIDTH + 8, dtype=torch.bfloat16)
        return (wide, wide.clone(), w, b, width), ValueError
    if kind == "shapes_differ":
        return (g, u[:1], w, b, width), ValueError
    if kind == "params_shape":
        return (g, u, w[:-1], b[:-1], width), ValueError
    if kind == "non_contiguous":
        wide = torch.cat([g, g], dim=-1)
        return (wide[..., :2736], u, w, b, width), ValueError
    if kind == "cpu":
        return (g, u, w, b, width), RuntimeError
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["fp32_input", "bf16_params", "width_past_row",
                                  "row_not_multiple_of_8", "row_too_wide", "shapes_differ",
                                  "params_shape", "non_contiguous", "cpu"])
def test_checks_reject_what_the_kernel_does_not_take(kind):
    args, error = _malformed(kind)
    with pytest.raises(error, match="swiglu_norm_fwd"):
        sn._checked(*args)


def test_bound_is_the_bytes_of_one_pass():
    # EVA-02-L at 448, batch 64: g and u read, the output written
    assert sn.bound_bytes(64 * 1025, 2736) == 1_076_889_600
    assert sn.bound_bytes(64 * 1025, 2736) / 3.35e12 * 1e3 == pytest.approx(0.3215, abs=1e-4)
