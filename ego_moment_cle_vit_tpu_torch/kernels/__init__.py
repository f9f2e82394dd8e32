"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.  Each counts its launches in a plain
integer attribute, ``<wrapper>.launches``.  The differentiable entry points
are ``gpf.gpf`` and ``window_attention.window_attention`` in the two modules
(``torch.autograd.Function``s whose forward and backward go through those
wrappers); they are not re-exported here, where their names are the modules'.
"""

from .gpf import GPFFunction, gpf_bwd, gpf_bwd_plain, gpf_fwd, gpf_plain
from .window_attention import (
    WindowAttentionFunction,
    window_attention_bwd,
    window_attention_bwd_plain,
    window_attention_fwd,
    window_attention_plain,
)

__all__ = [
    "GPFFunction",
    "gpf_bwd",
    "gpf_bwd_plain",
    "gpf_fwd",
    "gpf_plain",
    "WindowAttentionFunction",
    "window_attention_bwd",
    "window_attention_bwd_plain",
    "window_attention_fwd",
    "window_attention_plain",
]
