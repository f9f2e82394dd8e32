"""Seeded inputs and weights, made on the device in a few large calls.

The benchmark makes every tensor both sides see: the weights, loaded into the
program and into the reference by name (``load_state_dict(strict=True)``),
and the uint8 batches and labels.  Each comes from its own generator on the
device, seeded from ``(seed, purpose)``, so one seed gives the same tensors in
every run on the same kind of device.
"""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, purpose: str) -> int:
    """A 63-bit generator seed from the run's seed and a purpose."""
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose))


def leaf_kind(name: str) -> str:
    """How a leaf is drawn, from its name."""
    last = name.rsplit(".", 1)[-1]
    if last == "sketch_matrices":
        return "sketch"
    if last == "alpha_coeffs":
        return "coeffs"
    if last in ("relative_position_bias_table", "cls_token", "pos_embed"):
        return "table"
    if last == "bias":
        return "bias"
    return "weight"


def make_weights(shapes: dict, dtypes: dict, norms: set, seed: int, device) -> dict:
    """{name: tensor} for every leaf in ``shapes`` ({name: shape}), in the
    dtype ``dtypes`` gives it.  ``norms`` names the LayerNorm leaves.

    One normal draw, clipped at +-2, covers every float leaf: weights scaled
    by 1/sqrt(fan-in), biases, tables and norm offsets by 0.02, norm scales
    1 + 0.02 z, GPF coefficients 0.05 + 0.025 z (in [0, 0.1]).  The sketch
    matrices are signed one-hot rows from one integer draw."""
    g = generator(seed, "weights", device)
    floats = [n for n in shapes if leaf_kind(n) != "sketch"]
    total = sum(torch.Size(shapes[n]).numel() for n in floats)
    z = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name in floats:
        shape = torch.Size(shapes[name])
        x = z[at:at + shape.numel()].view(shape)
        at += shape.numel()
        kind = leaf_kind(name)
        if name in norms:
            x = 1.0 + 0.02 * x if kind == "weight" else 0.02 * x
        elif kind == "weight":
            x = x / shape[1:].numel() ** 0.5
        elif kind == "coeffs":
            x = 0.05 + 0.025 * x
        else:
            x = 0.02 * x
        out[name] = x.to(dtypes[name])
    del z
    for name in (n for n in shapes if leaf_kind(n) == "sketch"):
        three, d, k = shapes[name]
        r = torch.randint(0, 2 * k, (three, d), generator=g, device=device)
        rows = torch.zeros(three, d, k, device=device)
        rows.scatter_(2, (r % k)[..., None], (1.0 - 2.0 * (r // k)).float()[..., None])
        out[name] = rows.to(dtypes[name])
    return out


def make_batches(seed: int, count: int, batch: int, size: int, classes: int, device):
    """``count`` distinct uint8 batches [batch, size, size, 3] and int64
    labels [batch], all on ``device``."""
    g = generator(seed, "inputs", device)
    images = torch.randint(0, 256, (count, batch, size, size, 3), generator=g, device=device,
                           dtype=torch.uint8)
    labels = torch.randint(0, classes, (count, batch), generator=g, device=device)
    return list(images.unbind(0)), list(labels.unbind(0))
