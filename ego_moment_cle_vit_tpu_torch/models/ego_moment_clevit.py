"""EGOMomentCLEViT, the composition root.

Counterpart of ``ego_moment_cle_vit_tpu/models/ego_moment_clevit.py:39-362``:
dual-stream backbone -> GPF (static or adaptive) -> moment head (full or
simplified) -> classifier (standard, multi-scale or adaptive) plus
the per-view auxiliary classifier and the five-term loss dictionary (three
cross-entropies, the roll-negative triplet, the graph-alignment MSE);
``inference`` as the single-view serving forward; ``ablation_forward``
(JAX ``:275-307``), the evaluator's ablations.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..losses import alignment_mse_from_means, roll_negative_triplet_loss
from ..ops.moments import _wide
from ..parallel.collectives import gather_batch
from ..parallel.shard_kernels import active_kernel_mesh
from ..utils.device import pin_fp32_precision, resolve_device
from ..utils.trace import span
from .backbone import CLEViTDualStream, backbone_num_features, backbone_num_patches
from .classifier_head import AdaptiveClassifierHead, ClassifierHead, MultiScaleClassifierHead
from .gpf import AdaptiveGraphPolynomialFusion, GraphPolynomialFusion
from .layers import Dense, init_parameters
from .moment_head import MomentHead, SimplifiedMomentHead, check_dense_route


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood, taken in fp32 (fp64 for fp64 logits)."""
    logp = F.log_softmax(_wide(logits), dim=-1)
    return -torch.gather(logp, 1, labels[:, None].long())[:, 0].mean()


class EGOMomentCLEViT(nn.Module):
    """Call signature mirrors the JAX model: ``(anchor, positive, labels=None,
    return_features=False)`` -> dict of logits / losses / features.  Dropout
    follows ``self.training`` and draws from the ``generator`` given to
    ``forward``."""

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
        gpf_adaptive_type: Optional[str] = None,
        moment_variant: str = "full",
        moment_d_out: int = 1024,
        use_third_order: bool = True,
        isqrt_iterations: int = 5,
        sketch_dim: int = 4096,
        sketch_mode: str = "fft",
        classifier_type: str = "standard",
        classifier_fusion: str = "concat",
        classifier_hidden: Optional[int] = None,
        lambda_triplet: float = 1.0,
        lambda_align: float = 0.1,
        margin: float = 0.3,
        dropout: float = 0.1,
        norm: str = "layer",
        backbone_remat: str = "attn",
        backbone_attn_kernel: str = "auto",
        moment_remat: bool = False,
        moment_bf16_params: bool = False,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cpu",
    ):
        super().__init__()
        self.dtype = dtype
        self.lambda_triplet = lambda_triplet
        self.lambda_align = lambda_align
        self.margin = margin
        self.backbone = CLEViTDualStream(backbone_name, img_size, dtype, device,
                                         drop_rate=dropout, remat=backbone_remat,
                                         attn_kernel=backbone_attn_kernel)
        d = self.backbone.num_features
        gpf_args = dict(degree_p=gpf_degree_p, degree_q=gpf_degree_q, similarity=gpf_similarity,
                        symmetric_enforce=gpf_symmetric_enforce, coeff_init=gpf_coeff_init,
                        device=device)
        if gpf_adaptive_type is None:
            self.gpf = GraphPolynomialFusion(**gpf_args)
        else:
            self.gpf = AdaptiveGraphPolynomialFusion(
                **gpf_args, adaptive_type=gpf_adaptive_type,
                num_tokens=backbone_num_patches(backbone_name, img_size), dim=d, dtype=dtype)
        if moment_variant == "simplified":
            self.moment_head = SimplifiedMomentHead(
                d, moment_d_out, use_third_order, isqrt_iterations, dropout=dropout,
                dtype=dtype, device=device)
        elif moment_variant == "full":
            self.moment_head = MomentHead(
                d, moment_d_out, use_third_order, isqrt_iterations, sketch_dim, sketch_mode,
                norm=norm, bf16_params=moment_bf16_params, dtype=dtype, device=device,
                dropout=dropout, remat=moment_remat,
            )
        else:
            raise ValueError(f"Unknown moment variant: {moment_variant!r} "
                             "(expected 'full' or 'simplified')")
        head_args = dict(norm=norm, dtype=dtype, device=device, dropout=dropout)
        if classifier_type == "multiscale":
            self.classifier = MultiScaleClassifierHead(d, moment_d_out, num_classes, **head_args)
        elif classifier_type == "adaptive":
            self.classifier = AdaptiveClassifierHead(d, moment_d_out, num_classes, **head_args)
        else:
            self.classifier = ClassifierHead(d, moment_d_out, num_classes, classifier_hidden,
                                             classifier_fusion, **head_args)
        self.cls_only_classifier = Dense(d, num_classes, dtype=dtype, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (flax-like initializers)."""
        init_parameters(self, generator)
        self.gpf.reset_parameters(generator)
        self.moment_head.reset_sketch(generator)

    def forward(
        self,
        anchor: torch.Tensor,
        positive: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        return_features: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Dual-view forward.  anchor, positive: normalized NHWC [B, H, W, 3];
        labels [B] int.  Returns ``logits``, ``logits_anchor``,
        ``logits_positive`` and, given labels, ``loss_dict`` and ``loss``."""
        with span("backbone"):
            anchor_features, positive_features = self.backbone(anchor, positive, generator)
        anchor_tokens = anchor_features["patch_tokens"]
        positive_tokens = positive_features["patch_tokens"]
        anchor_global = anchor_features["global_features"]
        positive_global = positive_features["global_features"]

        with span("gpf"):
            fused_graph = self.gpf(anchor_tokens, positive_tokens)
        with span("moment_head"):
            moment_features = self.moment_head(anchor_tokens, fused_graph, generator)
        with span("classifier"):
            main_logits = self.classifier(anchor_global, moment_features, generator)
        anchor_logits = self.cls_only_classifier(anchor_global)
        positive_logits = self.cls_only_classifier(positive_global)

        output: Dict[str, Any] = {
            "logits": main_logits,
            "logits_anchor": anchor_logits,
            "logits_positive": positive_logits,
        }
        if labels is not None:
            with span("train.loss"):
                loss_dict = self._compute_losses(
                    main_logits, anchor_logits, positive_logits, anchor_global, positive_global,
                    fused_graph, labels,
                )
                output["loss_dict"] = loss_dict
                output["loss"] = sum(loss_dict.values())
        if return_features:
            output["features"] = {
                "anchor_tokens": anchor_tokens,
                "positive_tokens": positive_tokens,
                "anchor_global": anchor_global,
                "positive_global": positive_global,
                "fused_graph": fused_graph,
                "moment_features": moment_features,
                "gpf_coefficients": self.gpf.coefficient_matrix(),
            }
        return output

    def _compute_losses(self, main_logits, anchor_logits, positive_logits, anchor_global,
                        positive_global, fused_graph, labels) -> Dict[str, torch.Tensor]:
        """3x CE + lambda_t * roll-negative triplet + lambda_a * alignment.  A
        zero-weight term is left out, not multiplied by zero.

        On a mesh (``parallel.kernel_mesh``) the terms mix samples across the
        global batch (the roll's negative of sample 0 is the global batch's
        last, the alignment's [B, B] outer product, the means), so what they
        read is gathered over the data group first: the three logits, the
        labels, the two global features and the per-sample graph means (not
        the [B, N, N] graphs).  Every rank then computes the global loss."""
        graph_means = None
        if self.lambda_align > 0:
            graph_means = _wide(fused_graph).mean(dim=(1, 2))
        anchor_global, positive_global = _wide(anchor_global), _wide(positive_global)
        mesh = active_kernel_mesh()
        if mesh is not None:
            main_logits, anchor_logits, positive_logits, labels = (
                gather_batch(t, mesh) for t in (main_logits, anchor_logits, positive_logits,
                                                labels))
            if self.lambda_triplet > 0:
                anchor_global = gather_batch(anchor_global, mesh)
                positive_global = gather_batch(positive_global, mesh)
            if graph_means is not None:
                graph_means = gather_batch(graph_means, mesh)
        loss_dict = {
            "loss_main_ce": cross_entropy_loss(main_logits, labels),
            "loss_anchor_ce": cross_entropy_loss(anchor_logits, labels),
            "loss_positive_ce": cross_entropy_loss(positive_logits, labels),
        }
        if self.lambda_triplet > 0:
            loss_dict["loss_triplet"] = self.lambda_triplet * roll_negative_triplet_loss(
                anchor_global, positive_global, margin=self.margin
            )
        if graph_means is not None:
            loss_dict["loss_align"] = self.lambda_align * alignment_mse_from_means(
                graph_means, labels)
        return loss_dict

    def ablation_forward(self, anchor: torch.Tensor, positive: torch.Tensor,
                         mode: str = "full") -> torch.Tensor:
        """Logits of an ablated model on trained weights (the evaluator runs
        it in eval mode; dropout follows ``self.training`` as in ``forward``):

        'full'           the standard forward;
        'no_gpf'         the identity relation graph in place of the fused one;
        'uniform_graph'  the all-ones graph (unweighted moment pooling);
        'cls_only'       no moments: the auxiliary per-view classifier on the
                         anchor's global feature (one backbone pass).
        """
        if mode == "cls_only":
            with span("backbone"):
                feats = self.backbone.forward_single(anchor)
            return self.cls_only_classifier(feats["global_features"])
        with span("backbone"):
            anchor_features, positive_features = self.backbone(anchor, positive)
        tokens = anchor_features["patch_tokens"]
        b, n, _ = tokens.shape
        if mode == "no_gpf":
            graph = torch.eye(n, dtype=tokens.dtype, device=tokens.device).expand(b, n, n)
        elif mode == "uniform_graph":
            graph = torch.ones(b, n, n, dtype=tokens.dtype, device=tokens.device)
        elif mode == "full":
            with span("gpf"):
                graph = self.gpf(tokens, positive_features["patch_tokens"])
        else:
            raise ValueError(f"Unknown ablation mode: {mode}")
        with span("moment_head"):
            moment_features = self.moment_head(tokens, graph)
        with span("classifier"):
            return self.classifier(anchor_features["global_features"], moment_features)

    def inference(self, images: torch.Tensor) -> torch.Tensor:
        """Single-view inference: one backbone pass, R_p := R_a.

        images: normalized NHWC [B, H, W, 3] -> logits [B, num_classes].
        """
        with span("backbone"):
            feats = self.backbone.forward_single(images)
        tokens = feats["patch_tokens"]
        with span("gpf"):
            graph = self.gpf(tokens, tokens)
        with span("moment_head"):
            moments = self.moment_head(tokens, graph)
        with span("classifier"):
            return self.classifier(feats["global_features"], moments)


def create_model(
    config: Dict[str, Any], num_classes: int, *, device: str | torch.device = "cuda",
    seed: int = 0, dtype: torch.dtype | None = None,
) -> EGOMomentCLEViT:
    """Build the model from a config dict shaped like configs/ufg_base.yaml,
    with random weights drawn from ``seed`` on ``device``.

    ``dtype`` overrides the compute type the config gives (bf16 where
    ``model.bf16``, else fp32).  ``torch.float64`` also holds every parameter
    and buffer in fp64: a reference free of fp32 rounding, for the kernels'
    plain versions (the CUDA kernels take no fp64).

    Runs on the GPU unless ``device='cpu'``; raises without a GPU.  On the
    GPU it pins full-fp32 matmuls and convolutions (no TF32).  On the GPU a
    dense moment route (N >= D) at a width no Newton–Schulz kernel takes
    raises ``NotImplementedError`` (none of the registered backbones has
    one).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_precision()
    mcfg = config.get("model", {})
    gpf = mcfg.get("gpf", {})
    moment = mcfg.get("moment", {})
    classifier = mcfg.get("classifier", {})
    loss = config.get("training", {}).get("loss", {})
    backbone_name = mcfg.get("backbone_name", "swin_base_patch4_window7_224")
    img_size = config.get("data", {}).get("input_size")
    d_tok = backbone_num_features(backbone_name)
    variant = moment.get("variant", "full")
    if variant == "full" and backbone_num_patches(backbone_name, img_size) >= d_tok:  # dense
        check_dense_route(d_tok, dev)
    if dtype is None:
        dtype = torch.bfloat16 if mcfg.get("bf16", False) else torch.float32
    model = EGOMomentCLEViT(
        num_classes=num_classes,
        backbone_name=backbone_name,
        img_size=img_size,
        gpf_degree_p=gpf.get("degree_p", 2),
        gpf_degree_q=gpf.get("degree_q", 2),
        gpf_similarity=gpf.get("similarity", "cosine"),
        gpf_symmetric_enforce=gpf.get("symmetric_enforce", True),
        gpf_coeff_init=gpf.get("coeff_init", "uniform"),
        gpf_adaptive_type=gpf.get("adaptive_type"),
        moment_variant=variant,
        moment_d_out=moment.get("d_out", 1024),
        use_third_order=moment.get("use_third_order", True),
        isqrt_iterations=moment.get("isqrt_iterations", 5),
        sketch_dim=moment.get("sketch_dim", 4096),
        sketch_mode=moment.get("sketch_mode", "fft"),
        classifier_type=classifier.get("type", "standard"),
        classifier_fusion=classifier.get("fusion_type", "concat"),
        classifier_hidden=classifier.get("hidden_dim"),
        lambda_triplet=loss.get("lambda_triplet", 1.0),
        lambda_align=loss.get("lambda_align", 0.1),
        margin=loss.get("margin", 0.3),
        dropout=classifier.get("dropout", 0.1),
        norm=mcfg.get("norm", "layer"),
        backbone_remat=mcfg.get("backbone_remat", "attn"),
        backbone_attn_kernel=mcfg.get("backbone_attn_kernel", "auto"),
        moment_remat=moment.get("remat", False),
        moment_bf16_params=moment.get("bf16_params", False),
        dtype=dtype,
        device=dev,
    )
    if dtype == torch.float64:
        model.double()  # the leaves the JAX package keeps in fp32 whatever the compute type
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
