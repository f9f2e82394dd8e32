"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Entry points run on the GPU unless the caller asks for the CPU.

    Raises when a CUDA device is requested and none is present: the port
    never drops to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def pin_fp32_precision() -> None:
    """Full-fp32 matmuls and convolutions on the card.

    PyTorch runs fp32 convolutions through cuDNN in TF32 by default (about
    three decimal digits), and lets cuBLAS reduce bf16 products in reduced
    precision; the JAX reference does neither, so both are switched off.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def not_ported_parallelism(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, 'Modules to port', parallelism)")


def check_single_device(mesh_cfg: dict | None) -> None:
    """The port runs on one device: a config mesh with ``data`` or ``model``
    above one raises (``data: null`` means every device, here one)."""
    mesh_cfg = mesh_cfg or {}
    data = mesh_cfg.get("data")
    model = int(mesh_cfg.get("model", 1) or 1)
    if (data is not None and int(data) > 1) or model > 1:
        raise not_ported_parallelism(f"a mesh of data={data}, model={model}")
