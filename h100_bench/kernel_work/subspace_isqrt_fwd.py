"""Kernel 7, the token-subspace iSQRT of serving (N < D): A = centred tokens
and B = W A read, ``[B, N, D]``, and ``[B, D, D]`` written, in the model's
dtype.  Its products are fp32-accurate, each fp32 operand split into three
bf16 terms, so its operations are bf16 tensor-core operations (the same
arithmetic as the kernel's ``bound_flops``): per image the cross products
of S = B^ A^T (three where A is bf16, six where fp32), 2 + 5 (k - 2) N x N
products of six (iterations 1 and 2 run none or two), G B^ of six and
A^T (G B^) of three or six."""

from h100_bench.flops import family_of, isqrt_products
from h100_bench.kernel_work import SPLIT_PRODUCTS, element_size

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.subspace_isqrt:subspace_isqrt_fwd"
SOURCE = "subspace_isqrt"
SYMBOLS = r"::(product|trace|split|eye)_kernel\b"
DTYPE = "bfloat16"


def operations(n: int, d: int, k: int, exact_inputs: bool) -> float:
    """bf16 tensor-core operations of one image."""
    if k == 0:
        return 0.0
    six = SPLIT_PRODUCTS
    a_terms = 3 if exact_inputs else six
    last = 2.0 * d * d * n * a_terms
    if k == 1:
        return last
    products = isqrt_products("subspace", k, least=True)
    return (2.0 * n * n * d * a_terms + products * 2.0 * n ** 3 * six + 2.0 * n * n * d * six
            + last)


def work(spec: dict, batch: int, serving: bool) -> list:
    arch = spec["architecture"]
    n, d = family_of(arch).tokens(arch), arch["num_features"]
    k = spec["port_config"]["model"].get("moment", {}).get("isqrt_iterations", 5)
    es = element_size(spec)
    nbytes = (2 * batch * n * d + batch * d * d) * es
    return [(nbytes, batch * operations(n, d, k, exact_inputs=es == 2))]
