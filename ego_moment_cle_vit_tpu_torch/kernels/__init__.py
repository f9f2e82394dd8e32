"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.  Each counts its launches in a plain
integer attribute, ``<wrapper>.launches``.  The differentiable entry points
are ``gpf.gpf``, ``window_attention.window_attention`` and
``packed_attention.packed_attention`` in the three modules
(``torch.autograd.Function``s whose forward and backward go through those
wrappers); they are not re-exported here, where their names are the modules'.
"""

from .gpf import GPFFunction, gpf_bwd, gpf_bwd_plain, gpf_fwd, gpf_plain
from .packed_attention import (
    PackedAttentionFunction,
    packed_attention_bwd,
    packed_attention_bwd_plain,
    packed_attention_fwd,
    packed_attention_plain,
)
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
    "PackedAttentionFunction",
    "packed_attention_bwd",
    "packed_attention_bwd_plain",
    "packed_attention_fwd",
    "packed_attention_plain",
    "WindowAttentionFunction",
    "window_attention_bwd",
    "window_attention_bwd_plain",
    "window_attention_fwd",
    "window_attention_plain",
]
