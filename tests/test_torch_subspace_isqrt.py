"""The subspace iSQRT kernel's schedule and dispatch, on the CPU (no JAX).

``_schedule`` below runs the kernel's schedule (``csrc/subspace_isqrt.cu``)
with plain products: no product by G = 0 (iteration 1) or by G = -I/2
(iteration 2's three are exact scalings).  It must give
``ops.moments.isqrt_cov_subspace``'s results bit for bit (``torch.equal``) in
fp64 and fp32: leaving those products out changes no element.  The moment head takes the kernel only on the card and only where no
input wants a gradient; elsewhere ``isqrt_cov_subspace`` under autograd.  The
kernel itself is held on the card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from ego_moment_cle_vit_tpu_torch.kernels import subspace_isqrt as si
from ego_moment_cle_vit_tpu_torch.models import moment_head
from ego_moment_cle_vit_tpu_torch.ops.graph import normalize_graph
from ego_moment_cle_vit_tpu_torch.ops.moments import (
    _wide,
    graph_weighted_mean,
    isqrt_cov_subspace,
)

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)


def _inputs(b, n, d, dtype, seed=0):
    """centered and weighted as the moment head makes them."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randn(b, n, d, generator=g, dtype=torch.float64)
    graph = torch.rand(b, n, n, generator=g, dtype=torch.float64)
    w = normalize_graph(0.5 * (graph + graph.transpose(1, 2)), "symmetric", eps=1e-5)
    centered = tokens - graph_weighted_mean(tokens, w)[:, None, :]
    return centered.to(dtype), torch.matmul(w, centered).to(dtype)


def _schedule(centered, weighted, num_iterations, eps):
    """The kernel's schedule with plain products: ``isqrt_cov_subspace`` with
    the products by G = 0 and G = -I/2 written as what they are.  ``[B, N, D]``
    twice -> ``[B, D, D]`` in the input dtype, fp32 inside (fp64 for fp64)."""
    a = _wide(centered)
    b = _wide(weighted)
    n = a.shape[-2]
    t = torch.sum(a * b, dim=(-2, -1))[..., None, None] + eps
    bh = b / t
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    a_k = 1.5 ** num_iterations
    if num_iterations == 0:
        out = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device) / torch.sqrt(t)
        return out.to(centered.dtype)
    if num_iterations == 1:
        gb = -0.5 * bh
    else:
        s = torch.matmul(bh, a.transpose(-1, -2))
        # iteration 2 from G = -I/2: X = 3 G + S / 4, H = 2.25 I + S X,
        # G <- 1.5 G - 0.5 (1.5 H - (S H) / 2)
        x = -1.5 * eye + 0.25 * s
        h = 2.25 * eye + torch.matmul(s, x)
        g = -0.75 * eye - 0.5 * (1.5 * h + -0.5 * torch.matmul(s, h))
        a_it = 1.5
        for _ in range(2, num_iterations):
            a_it = 1.5 * a_it
            sg = torch.matmul(s, g)
            x = 2.0 * a_it * g + torch.matmul(g, sg)
            h = (a_it * a_it) * eye + torch.matmul(s, x)
            g = 1.5 * g - 0.5 * (a_it * h + torch.matmul(g, torch.matmul(s, h)))
        gb = torch.matmul(g, bh)
    out = torch.matmul(a.transpose(-1, -2), gb)
    out.diagonal(dim1=-2, dim2=-1).add_(a_k)
    return (out / torch.sqrt(t)).to(centered.dtype)


@pytest.mark.parametrize("iterations", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("n, d", [(49, 128), (16, 64)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_schedule_equals_isqrt_cov_subspace(dtype, n, d, iterations):
    centered, weighted = _inputs(2, n, d, dtype)
    got = _schedule(centered, weighted, iterations, 1e-5)
    want = isqrt_cov_subspace(centered, weighted, iterations, 1e-5)
    assert got.dtype == dtype and got.shape == (2, d, d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_the_plain_version_on_the_cpu(dtype):
    centered, weighted = _inputs(3, 20, 48, dtype, seed=1)
    before = si.subspace_isqrt_fwd.launches
    got = si.subspace_isqrt_fwd(centered, weighted, 5)
    assert si.subspace_isqrt_fwd.launches == before
    assert got.dtype == dtype
    assert torch.equal(got, isqrt_cov_subspace(centered, weighted, 5))


def test_wrapper_terms_is_a_keyword_only_test_hook():
    """The two-term control is reached only by the private keyword."""
    centered, weighted = _inputs(1, 8, 16, torch.float32)
    with pytest.raises(TypeError):
        si.subspace_isqrt_fwd(centered, weighted, 3, 1e-5, 2)
    with pytest.raises(TypeError):
        si.subspace_isqrt_fwd(centered, weighted, 3, terms=2)


def test_wrapper_checks_the_device():
    centered, weighted = _inputs(1, 8, 16, torch.float32)
    with pytest.raises(RuntimeError, match="unsupported device"):
        si._checked(centered.to("meta"), weighted.to("meta"), 3, 3)


@pytest.mark.parametrize("wants_grad", [False, True])
def test_moment_head_dispatch(monkeypatch, wants_grad):
    """On the card (stood in for here), the subspace branch takes the kernel
    only where no input requires grad."""
    calls = []

    def kernel(centered, weighted, iterations, eps):
        calls.append("kernel")
        return _schedule(centered, weighted, iterations, eps)

    def plain(centered, weighted, iterations, eps):
        calls.append("plain")
        return isqrt_cov_subspace(centered, weighted, iterations, eps)

    monkeypatch.setattr(moment_head, "_on_card", lambda t: True)
    monkeypatch.setattr(moment_head._si, "subspace_isqrt_fwd", kernel)
    monkeypatch.setattr(moment_head, "isqrt_cov_subspace", plain)
    head = moment_head.MomentHead(32, d_out=16, isqrt_iterations=5)
    centered, weighted = _inputs(2, 12, 32, torch.float32)
    if wants_grad:
        centered.requires_grad_()
    out = head._isqrt(centered, weighted)
    assert calls == (["plain"] if wants_grad else ["kernel"])
    assert out.requires_grad == wants_grad
    assert torch.equal(out.detach(), isqrt_cov_subspace(centered.detach(), weighted, 5, head.eps))


def test_moment_head_forward_is_unchanged_without_grad():
    """The CPU takes the plain iteration with or without a gradient: the head's
    output under ``inference_mode`` is its output with grad, bit for bit."""
    head = moment_head.MomentHead(32, d_out=16, isqrt_iterations=5, dropout=0.0).eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    tokens = torch.randn(2, 12, 32, generator=g)
    graph = torch.rand(2, 12, 12, generator=g)
    graph = 0.5 * (graph + graph.transpose(1, 2))
    with_grad = head(tokens, graph)
    with torch.inference_mode():
        without = head(tokens, graph)
    assert torch.equal(with_grad.detach(), without)


@pytest.mark.parametrize("n", [1, 7, 8, 49, 196, 784])
def test_scratch_layout(n):
    """Row pitches are whole 16-byte TMA rows; the scratch holds the traces,
    S, G twice, the work matrices or G B^, B^ (and A in fp32)."""
    b, d = 3, 64
    p = si.pitch(n)
    assert p % 8 == 0 and n <= p < n + 8
    nn, nd = n * p, n * d
    bf16 = 256 + 2 * (9 * b * nn + max(6 * b * nn, 3 * b * nd) + 3 * b * nd)
    assert si.scratch_bytes(b, n, d, torch.bfloat16) == bf16
    assert si.scratch_bytes(b, n, d, torch.float32) == bf16 + 2 * 3 * b * nd


def test_schedule_counts():
    """2 + 5 (k - 2) N x N products for k >= 2 (17 at k = 5, of the plain
    iteration's 25), and the bound of a ViT-L/448 call: 7.33e12 bf16 flops."""
    assert [si.products(k) for k in range(7)] == [0, 0, 2, 7, 12, 17, 22]
    flops = si.bound_flops(64, 784, 1024, 5, exact_inputs=True)
    assert flops == 64 * (3 * 2 * 784 ** 2 * 1024 + 17 * 6 * 2 * 784 ** 3
                          + 6 * 2 * 784 ** 2 * 1024 + 3 * 2 * 1024 ** 2 * 784)
    assert 7.2e12 < flops < 7.4e12
    assert si.bound_flops(2, 16, 64, 0, True) == 0
    assert si.bound_flops(2, 16, 64, 1, False) == 2 * 6 * 2 * 64 * 64 * 16


def test_bound_is_the_benchmarks_work():
    """The bound's operations and bytes of a ViT-L/448 serving call are those
    the benchmark's roofline counts for kernel 7."""
    from h100_bench.kernel_work import subspace_isqrt_fwd as work

    for exact in (True, False):
        assert si.bound_flops(64, 784, 1024, 5, exact) == 64 * work.operations(784, 1024, 5,
                                                                                exact)
    assert si.bound_bytes(64, 784, 1024, 2) == (2 * 64 * 784 * 1024 + 64 * 1024 ** 2) * 2
