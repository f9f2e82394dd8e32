"""EGOMomentCLEViT, the composition root (serving path).

Counterpart of ``ego_moment_cle_vit_tpu/models/ego_moment_clevit.py:45-180,
309-362``: backbone -> GPF -> MomentHead -> ClassifierHead, with
``inference`` as the one ported forward.  The full dual-view forward and the
five-term loss are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..utils.device import pin_fp32_precision, resolve_device
from .backbone import CLEViTDualStream
from .classifier_head import ClassifierHead, _not_ported
from .gpf import GraphPolynomialFusion
from .layers import Dense, init_parameters
from .moment_head import MomentHead


class EGOMomentCLEViT(nn.Module):
    def __init__(
        self,
        num_classes: int,
        backbone_name: str = "swin_base_patch4_window7_224",
        img_size: Optional[int] = None,
        gpf_degree_p: int = 2,
        gpf_degree_q: int = 2,
        gpf_similarity: str = "cosine",
        gpf_symmetric_enforce: bool = True,
        gpf_coeff_init: str = "uniform",
        moment_d_out: int = 1024,
        use_third_order: bool = True,
        isqrt_iterations: int = 5,
        sketch_dim: int = 4096,
        sketch_mode: str = "fft",
        classifier_fusion: str = "concat",
        classifier_hidden: Optional[int] = None,
        norm: str = "layer",
        moment_bf16_params: bool = False,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cpu",
    ):
        super().__init__()
        self.dtype = dtype
        self.backbone = CLEViTDualStream(backbone_name, img_size, dtype, device)
        d = self.backbone.num_features
        self.gpf = GraphPolynomialFusion(
            gpf_degree_p, gpf_degree_q, gpf_similarity,
            symmetric_enforce=gpf_symmetric_enforce, coeff_init=gpf_coeff_init, device=device,
        )
        self.moment_head = MomentHead(
            d, moment_d_out, use_third_order, isqrt_iterations, sketch_dim, sketch_mode,
            norm=norm, bf16_params=moment_bf16_params, dtype=dtype, device=device,
        )
        self.classifier = ClassifierHead(
            d, moment_d_out, num_classes, classifier_hidden, classifier_fusion, norm,
            dtype=dtype, device=device,
        )
        self.cls_only_classifier = Dense(d, num_classes, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (flax-like initializers)."""
        init_parameters(self, generator)
        self.gpf.reset_parameters(generator)
        self.moment_head.reset_sketch(generator)

    def forward(self, anchor, positive, labels=None):
        raise NotImplementedError(
            "the dual-view forward and its five-term loss belong to training, which is not "
            "ported yet (ROADMAP.md, 'Modules to port', training slice); use inference()"
        )

    def inference(self, images: torch.Tensor) -> torch.Tensor:
        """Single-view inference: one backbone pass, R_p := R_a.

        images: normalized NHWC [B, H, W, 3] -> logits [B, num_classes].
        """
        feats = self.backbone.forward_single(images)
        tokens = feats["patch_tokens"]
        graph = self.gpf(tokens, tokens)
        moments = self.moment_head(tokens, graph)
        return self.classifier(feats["global_features"], moments)


def create_model(
    config: Dict[str, Any], num_classes: int, *, device: str | torch.device = "cuda",
    seed: int = 0,
) -> EGOMomentCLEViT:
    """Build the model from a config dict shaped like configs/ufg_base.yaml,
    with random weights drawn from ``seed`` on ``device``.

    Runs on the GPU unless ``device='cpu'``; raises without a GPU.  On the
    GPU it pins full-fp32 matmuls and convolutions (no TF32).  Options whose
    path is not ported yet raise ``NotImplementedError``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_precision()
    mcfg = config.get("model", {})
    gpf = mcfg.get("gpf", {})
    moment = mcfg.get("moment", {})
    classifier = mcfg.get("classifier", {})
    if gpf.get("adaptive_type") is not None:
        raise _not_ported("AdaptiveGraphPolynomialFusion")
    if moment.get("variant", "full") != "full":
        raise _not_ported(f"moment variant {moment.get('variant')!r}")
    if classifier.get("type", "standard") != "standard":
        raise _not_ported(f"classifier type {classifier.get('type')!r}")
    if mcfg.get("backbone_attn_kernel") == "fused_half":
        raise NotImplementedError(
            "attn_kernel='fused_half' is not ported yet (ROADMAP.md, 'TPU kernels to port', "
            "fused_attn_half_spatial)"
        )
    model = EGOMomentCLEViT(
        num_classes=num_classes,
        backbone_name=mcfg.get("backbone_name", "swin_base_patch4_window7_224"),
        img_size=config.get("data", {}).get("input_size"),
        gpf_degree_p=gpf.get("degree_p", 2),
        gpf_degree_q=gpf.get("degree_q", 2),
        gpf_similarity=gpf.get("similarity", "cosine"),
        gpf_symmetric_enforce=gpf.get("symmetric_enforce", True),
        gpf_coeff_init=gpf.get("coeff_init", "uniform"),
        moment_d_out=moment.get("d_out", 1024),
        use_third_order=moment.get("use_third_order", True),
        isqrt_iterations=moment.get("isqrt_iterations", 5),
        sketch_dim=moment.get("sketch_dim", 4096),
        sketch_mode=moment.get("sketch_mode", "fft"),
        classifier_fusion=classifier.get("fusion_type", "concat"),
        classifier_hidden=classifier.get("hidden_dim"),
        norm=mcfg.get("norm", "layer"),
        moment_bf16_params=moment.get("bf16_params", False),
        dtype=torch.bfloat16 if mcfg.get("bf16", False) else torch.float32,
        device=dev,
    )
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
