"""PyTorch/CUDA port of EGO-Moment-CLE-ViT for NVIDIA Hopper (H100).

A second package beside the JAX reference ``ego_moment_cle_vit_tpu``.  Module
names mirror the JAX package so each counterpart is easy to find; public
functions keep the JAX layouts (images NHWC ``[B, H, W, 3]``, tokens
``[B, N, D]``, window-attention qkv ``[B, Hp, Wp, 3C]``).

Ported so far: the serving path (eval preprocess -> Swin -> fused GPF ->
moment head -> classifier), with hand-written CUDA kernels for spatial window
attention and fused GPF (``kernels/``, sources in ``csrc/``).  Entry points
run on ``device="cuda"`` unless the caller passes ``device="cpu"``; without a
GPU they raise.  This package imports neither JAX nor the JAX package.
"""

from .models import EGOMomentCLEViT, create_model
from .serve import make_infer_fn

__all__ = ["EGOMomentCLEViT", "create_model", "make_infer_fn"]
