"""Kernel 2, GPF forward: the token sets read (one when both views are the
same tensor, as in serving), the [B, N, N] fp32 graph written; the Grams'
upper triangles, 2 D N(N+1)/2 flops each."""

from h100_bench.flops import family_of
from h100_bench.kernel_work import element_size

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.gpf:gpf_fwd"
SOURCE = "gpf_fwd"
SYMBOLS = r"gpf_fwd_sm90|gpf_fwd_kernel"


def work(spec: dict, batch: int, serving: bool) -> list:
    arch = spec["architecture"]
    n = family_of(arch).tokens(arch)
    d, n_in = arch["num_features"], (1 if serving else 2)
    nbytes = n_in * batch * n * d * element_size(spec) + batch * n * n * 4 + 36
    return [(nbytes, n_in * 2.0 * batch * d * n * (n + 1) / 2)]
