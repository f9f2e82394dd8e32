"""PyTorch/CUDA port of EGO-Moment-CLE-ViT for NVIDIA Hopper (H100).

A second package beside the JAX reference ``ego_moment_cle_vit_tpu``.  Module
names mirror the JAX package so each counterpart is easy to find; public
functions keep the JAX layouts (images NHWC ``[B, H, W, 3]``, tokens
``[B, N, D]``, window-attention qkv ``[B, Hp, Wp, 3C]``).

Ported so far: the serving path (eval preprocess -> Swin -> fused GPF ->
moment head -> classifier) and the training step (dual-view augmentation, the
dual-view forward, the five-term loss, backward, AdamW with a factored second
moment for huge leaves and fp32 masters for bf16 ones), with hand-written CUDA
kernels for spatial window attention and fused GPF, forward and backward
(``kernels/``, sources in ``csrc/``); the data pipeline, the trainer, the
evaluator, checkpoints and the CLI (``data/``, ``train/``, ``cli/``); every
model, loss and training option of the JAX package on one device (adaptive
GPF, the simplified moment head, BatchNorm heads, the multi-scale, adaptive
and bilinear classifiers, gradient accumulation, the loss variants).  Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``;
without a GPU they raise.  This package imports neither JAX nor the JAX
package.
"""

from .models import EGOMomentCLEViT, create_model
from .serve import make_infer_fn
from .train import create_optimizer, create_train_state, make_train_step

__all__ = [
    "EGOMomentCLEViT",
    "create_model",
    "create_optimizer",
    "create_train_state",
    "make_infer_fn",
    "make_train_step",
]
