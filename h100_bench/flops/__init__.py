"""Model FLOPs from shapes: two per multiply-add, every matrix product and
convolution of the forward (elementwise work, softmax and FFTs not counted).
One module per backbone family (``swin``, ``vit``), found by the
configuration's ``architecture.family``, and ``heads`` for what follows the
backbone.  A training step counts three forwards (the backward as twice the
forward); recomputation under checkpointing is not counted."""

import importlib


def family_of(arch: dict):
    """The module of ``arch['family']``: ``forward_flops(arch, images)`` and
    ``tokens(arch)``, the patch tokens N the backbone emits."""
    return importlib.import_module(f"{__name__}.{arch['family']}")


def isqrt_products(route: str, k: int, least: bool) -> int:
    """Matrix products of k Newton–Schulz steps: D x D on the ``dense`` route,
    N x N in the token ``subspace``.  The model's count (``least=False``, for
    ``mfu``) is what the plain iteration runs: three a step dense, five in the
    subspace.  The least (``least=True``, for a kernel's roofline) is what the
    kernels run: the dense ones spare two of the first step's products (Y = I)
    and the last step's Z update, 3k - 3; kernel 7 runs iterations 1 and 2 in
    closed form, 5k - 8 from k = 2."""
    if route == "dense":
        return 3 * k - 3 if least else 3 * k
    if route == "subspace":
        return 5 * k - 8 if least else 5 * k
    raise ValueError(f"no route {route!r}")
