"""Kernel 5′, the bf16 Newton–Schulz iSQRT of the dense moment route (826 <=
D <= 1059): bf16 storage, fp32 sums, products on bf16 ``wgmma``.  Its device
kernels are 5″'s (``ns_sm90``, ``ns_bf16``): a configuration runs one of the
two, by its width."""

from h100_bench.kernel_work import isqrt_dense_work

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.newton_schulz:newton_schulz_isqrt_bf16_fwd"
SOURCE = "newton_schulz_bf16"
SYMBOLS = r"ns_sm90::gemm_sm90_kernel|ns_bf16::(init|finish)_kernel"
DTYPE = "bfloat16"


def work(spec: dict, batch: int, serving: bool) -> list:
    return isqrt_dense_work(spec, batch)
