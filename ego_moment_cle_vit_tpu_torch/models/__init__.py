"""PyTorch model modules: backbones, GPF, moment heads, classifiers, the model."""

from .backbone import CLEViTBackbone, CLEViTDualStream, backbone_num_features
from .classifier_head import AdaptiveClassifierHead, ClassifierHead, MultiScaleClassifierHead
from .ego_moment_clevit import EGOMomentCLEViT, create_model
from .gpf import AdaptiveGraphPolynomialFusion, GraphPolynomialFusion
from .moment_head import MomentHead, SimplifiedMomentHead
from .swin import SWIN_CONFIGS, Swin, SwinConfig

__all__ = [
    "AdaptiveClassifierHead",
    "AdaptiveGraphPolynomialFusion",
    "MultiScaleClassifierHead",
    "SimplifiedMomentHead",
    "CLEViTBackbone",
    "CLEViTDualStream",
    "backbone_num_features",
    "ClassifierHead",
    "EGOMomentCLEViT",
    "create_model",
    "GraphPolynomialFusion",
    "MomentHead",
    "SWIN_CONFIGS",
    "Swin",
    "SwinConfig",
]
