"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.  Each counts its launches in a plain
integer attribute, ``<wrapper>.launches``.
"""

from .gpf import gpf_fwd, gpf_plain
from .window_attention import window_attention_fwd, window_attention_plain

__all__ = ["gpf_fwd", "gpf_plain", "window_attention_fwd", "window_attention_plain"]
