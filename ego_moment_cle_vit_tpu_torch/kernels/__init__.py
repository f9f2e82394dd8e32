"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.  Each counts its launches in a plain
integer attribute, ``<wrapper>.launches``.  The differentiable entry points
are ``gpf.gpf``, ``window_attention.window_attention``, ``attn_half.attn_half``,
``packed_attention.packed_attention``,
``flash_attention.flash_attention_tiled`` and
``newton_schulz.newton_schulz_isqrt_kernel`` (``torch.autograd.Function``s
whose forward and backward go through those wrappers; the Newton–Schulz
forward dispatches by width to its fp32, bf16 or bf16-streamed kernel, and its
backward differentiates the plain fp32 iteration, as on the TPU); the first four
are not re-exported here, where their names are the modules'.
``subspace_isqrt.subspace_isqrt_fwd`` has no backward: the moment head calls it
only where no gradient is wanted; its plain version is
``ops.moments.isqrt_cov_subspace``.  Nor has ``swiglu_norm.swiglu_norm_fwd``,
which EVA's SwiGLU calls only where no gradient is wanted; its plain version
is ``swiglu_norm.swiglu_norm_plain``.
"""

from .attn_half import (
    AttnHalfFunction,
    attn_half_bwd,
    attn_half_bwd_plain,
    attn_half_fwd,
    attn_half_plain,
)
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
    newton_schulz_isqrt_bf16_fwd,
    newton_schulz_isqrt_bf16_plain,
    newton_schulz_isqrt_bf16_streamed_fwd,
    newton_schulz_isqrt_bf16_streamed_plain,
    newton_schulz_isqrt_fp32_fwd,
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
from .subspace_isqrt import subspace_isqrt_fwd
from .swiglu_norm import swiglu_norm_fwd, swiglu_norm_plain
from .window_attention import (
    WindowAttentionFunction,
    window_attention_bwd,
    window_attention_bwd_plain,
    window_attention_fwd,
    window_attention_plain,
)

__all__ = [
    "AttnHalfFunction",
    "attn_half_bwd",
    "attn_half_bwd_plain",
    "attn_half_fwd",
    "attn_half_plain",
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
    "newton_schulz_isqrt_bf16_fwd",
    "newton_schulz_isqrt_bf16_plain",
    "newton_schulz_isqrt_bf16_streamed_fwd",
    "newton_schulz_isqrt_bf16_streamed_plain",
    "newton_schulz_isqrt_fp32_fwd",
    "newton_schulz_isqrt_fwd",
    "newton_schulz_isqrt_kernel",
    "newton_schulz_isqrt_plain",
    "PackedAttentionFunction",
    "packed_attention_bwd",
    "packed_attention_bwd_plain",
    "packed_attention_fwd",
    "packed_attention_plain",
    "subspace_isqrt_fwd",
    "swiglu_norm_fwd",
    "swiglu_norm_plain",
    "WindowAttentionFunction",
    "window_attention_bwd",
    "window_attention_bwd_plain",
    "window_attention_fwd",
    "window_attention_plain",
]
