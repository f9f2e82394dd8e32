"""Kernel 5″, the streamed bf16 Newton–Schulz iSQRT of the dense moment route
(D = 1536): as 5′ with the products regrouped, on the same device kernels."""

from h100_bench.kernel_work import isqrt_dense_work

WRAPPER = ("ego_moment_cle_vit_tpu_torch.kernels.newton_schulz:"
           "newton_schulz_isqrt_bf16_streamed_fwd")
SOURCE = "newton_schulz_bf16_streamed"
SYMBOLS = r"ns_sm90::gemm_sm90_kernel|ns_bf16::(init|finish)_kernel"
DTYPE = "bfloat16"


def work(spec: dict, batch: int, serving: bool) -> list:
    return isqrt_dense_work(spec, batch)
