"""Tensor-Sketch third-order moment approximation.

Counterpart of ``ego_moment_cle_vit_tpu/ops/sketch.py``.  The count-sketch
stays a dense matmul ``x @ S`` with a fixed ``[D, K]`` signed one-hot matrix,
as in the JAX package; the JAX ``SketchParams`` is just those matrices here.
"""

from __future__ import annotations

import torch


def effective_sketch_dim(input_dim: int, sketch_dim: int, cap_ratio: int = 4) -> int:
    """min(sketch_dim, cap_ratio * D), rounded up to a multiple of 128."""
    k = min(sketch_dim, input_dim * cap_ratio)
    return ((k + 127) // 128) * 128


def make_sketch_matrices(
    input_dim: int,
    sketch_dim: int,
    cap_ratio: int = 4,
    *,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Three signed one-hot count-sketch matrices, ``[3, D, K]`` fp32.

    Drawn from ``generator``; the draw differs from the JAX package's
    ``jax.random.PRNGKey(42)`` one, so a model that must reproduce JAX
    outputs loads the JAX matrices through the weight converter instead.
    """
    k = effective_sketch_dim(input_dim, sketch_dim, cap_ratio)
    mats = torch.zeros(3, input_dim, k, dtype=torch.float32, device=device)
    rows = torch.arange(input_dim, device=device)
    for i in range(3):
        hashes = torch.randint(0, k, (input_dim,), generator=generator, device=device)
        signs = torch.randint(0, 2, (input_dim,), generator=generator, device=device) * 2 - 1
        mats[i, rows, hashes] = signs.float()
    return mats


def sketch_matrices_from_hashes(hashes: torch.Tensor, signs: torch.Tensor,
                                sketch_dim: int) -> torch.Tensor:
    """The ``[3, D, K]`` fp32 sketch matrices of explicit hash and sign
    tensors (``[3, D]`` each): S_i[d, h_i(d)] = s_i(d).  The counterpart of
    the JAX ``sketch_params_from_hashes``, whose ``SketchParams`` carries
    these matrices."""
    onehot = torch.nn.functional.one_hot(hashes.long(), sketch_dim).float()
    return onehot * signs[..., None].float()


def count_sketch(x: torch.Tensor, sketch_matrix: torch.Tensor) -> torch.Tensor:
    """Count-sketch of x as a product: [..., D] @ [D, K] -> [..., K] fp32."""
    xf = x if x.dtype == torch.float64 else x.float()
    return torch.matmul(xf, sketch_matrix.to(xf.dtype))


def tensor_sketch_3(
    x: torch.Tensor, matrices: torch.Tensor, mode: str = "fft"
) -> torch.Tensor:
    """[..., D] -> [..., K] third-order sketch, in x's dtype.

    'fft':      IFFT(FFT(s1) * FFT(s2) * FFT(s3)).real, length K.
    'faithful': s1 * s2 * s3 elementwise (the original reference estimator).
    """
    xf = x if x.dtype == torch.float64 else x.float()
    s1, s2, s3 = (count_sketch(xf, matrices[i]) for i in range(3))
    k = matrices.shape[-1]
    if mode == "faithful":
        out = s1 * s2 * s3
    elif mode == "fft":
        f = torch.fft.rfft(s1, dim=-1) * torch.fft.rfft(s2, dim=-1) * torch.fft.rfft(s3, dim=-1)
        out = torch.fft.irfft(f, n=k, dim=-1)
    else:
        raise ValueError(f"Unknown tensor-sketch mode: {mode}")
    return out.to(x.dtype)
