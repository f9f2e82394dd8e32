"""The serving program: uint8 images -> logits.

Counterpart of ``ego_moment_cle_vit_tpu/bench_core.py:60-78``
(``make_infer_fn``): eval preprocessing, then one ``inference`` pass.
"""

from __future__ import annotations

from typing import Callable

import torch

from .data.augment import AugmentConfig, dual_view_eval_batch
from .models.ego_moment_clevit import EGOMomentCLEViT
from .utils.device import pin_fp32_precision, resolve_device
from .utils.trace import span


def make_infer_fn(
    model: EGOMomentCLEViT, aug_cfg: AugmentConfig, *, device: str | torch.device = "cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``infer(images_u8) -> logits`` running on ``device``.

    The model must already live on ``device`` (``create_model(...,
    device=...)``).  ``images_u8``: uint8 ``[B, S, S, 3]``, moved to the
    device if it is not there.  Runs under ``torch.inference_mode()`` and
    returns without synchronizing the device.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_precision()
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, serving asked for {dev}")
    model.eval()

    def infer(images_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), span("serve.infer"):
            with span("serve.preprocess"):
                images = images_u8.to(model_dev, non_blocking=True)
                anchor, _ = dual_view_eval_batch(images, aug_cfg)
            return model.inference(anchor)

    return infer
