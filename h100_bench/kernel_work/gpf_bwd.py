"""Kernel 2b, GPF backward: both token sets and the graph's gradient read,
both token gradients and the coefficients' written; 8 B N^2 D flops."""

from h100_bench.flops import family_of
from h100_bench.kernel_work import element_size

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.gpf:gpf_bwd"
SOURCE = "gpf_bwd"
SYMBOLS = r"gpf_bwd_w_sm90|gpf_sm90::dx_kernel|gpf_bwd_w_kernel|gpf_fp32::dx_kernel"


def work(spec: dict, batch: int, serving: bool) -> list:
    arch = spec["architecture"]
    n = family_of(arch).tokens(arch)
    d = arch["num_features"]
    nbytes = 4 * batch * n * d * element_size(spec) + batch * n * n * 4 + batch * 36 + 36
    return [(nbytes, 8.0 * batch * n * n * d)]
