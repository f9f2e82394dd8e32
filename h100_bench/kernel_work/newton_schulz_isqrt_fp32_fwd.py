"""Kernel 5, the fp32 Newton–Schulz iSQRT of the dense moment route (D <=
825): its products are fp32-accurate whatever the model's dtype, so each
counts ``SPLIT_PRODUCTS`` bf16 tensor-core products at the bf16 peak, as
kernel 7's do (``kernel_work/__init__.py``)."""

from h100_bench.kernel_work import SPLIT_PRODUCTS, isqrt_dense_work

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.newton_schulz:newton_schulz_isqrt_fp32_fwd"
SOURCE = "newton_schulz"
SYMBOLS = r"::ns_(gemm|trace|init|finish)\b"
DTYPE = "bfloat16"


def work(spec: dict, batch: int, serving: bool) -> list:
    return isqrt_dense_work(spec, batch, per_product=SPLIT_PRODUCTS)
