"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.  Each counts its launches in a plain
integer attribute, ``<wrapper>.launches``.  The differentiable entry points
are ``gpf.gpf``, ``window_attention.window_attention``,
``packed_attention.packed_attention``,
``flash_attention.flash_attention_tiled`` and
``newton_schulz.newton_schulz_isqrt_kernel`` (``torch.autograd.Function``s
whose forward and backward go through those wrappers; the Newton–Schulz
backward differentiates the plain iteration, as on the TPU); the first three
are not re-exported here, where their names are the modules'.
"""

from .flash_attention import (
    FlashAttentionTiledFunction,
    flash_attention_tiled,
    flash_attention_tiled_bwd,
    flash_attention_tiled_bwd_plain,
    flash_attention_tiled_fwd,
    flash_attention_tiled_plain,
)
from .gpf import GPFFunction, gpf_bwd, gpf_bwd_plain, gpf_fwd, gpf_plain
from .newton_schulz import (
    NewtonSchulzFunction,
    newton_schulz_isqrt_fwd,
    newton_schulz_isqrt_kernel,
    newton_schulz_isqrt_plain,
)
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
    "FlashAttentionTiledFunction",
    "flash_attention_tiled",
    "flash_attention_tiled_bwd",
    "flash_attention_tiled_bwd_plain",
    "flash_attention_tiled_fwd",
    "flash_attention_tiled_plain",
    "GPFFunction",
    "gpf_bwd",
    "gpf_bwd_plain",
    "gpf_fwd",
    "gpf_plain",
    "NewtonSchulzFunction",
    "newton_schulz_isqrt_fwd",
    "newton_schulz_isqrt_kernel",
    "newton_schulz_isqrt_plain",
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
