"""PyTorch model modules of the serving path."""

from .backbone import CLEViTBackbone, CLEViTDualStream, backbone_num_features
from .classifier_head import ClassifierHead
from .ego_moment_clevit import EGOMomentCLEViT, create_model
from .gpf import GraphPolynomialFusion
from .moment_head import MomentHead
from .swin import SWIN_CONFIGS, Swin, SwinConfig

__all__ = [
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
