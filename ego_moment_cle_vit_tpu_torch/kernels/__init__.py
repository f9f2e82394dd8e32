"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel or raises.  Each counts its launches in a plain
integer attribute, ``<wrapper>.launches``, through ``_build.launch``, which
also opens the wrapper's ``kernel.<wrapper>`` span.  Import the modules:
nothing is re-exported here.  The differentiable entry points
are ``gpf.gpf``, ``window_attention.window_attention``, ``attn_half.attn_half``,
``packed_attention.packed_attention``,
``flash_attention.flash_attention_tiled`` and
``newton_schulz.newton_schulz_isqrt_kernel`` (``torch.autograd.Function``s
whose forward and backward go through those wrappers; the Newton–Schulz
forward dispatches by width to its fp32, bf16 or bf16-streamed kernel, and its
backward differentiates the plain fp32 iteration, as on the TPU).
``subspace_isqrt.subspace_isqrt_fwd`` has no backward: the moment head calls it
only where no gradient is wanted; its plain version is
``ops.moments.isqrt_cov_subspace``.  Nor has ``swiglu_norm.swiglu_norm_fwd``,
which EVA's SwiGLU calls only where no gradient is wanted; its plain version
is ``swiglu_norm.swiglu_norm_plain``.
"""
