"""Swin backbone FLOPs: patch convolution, per block qkv / attention / proj /
MLP on the window-padded canvas, patch merging."""


def forward_flops(arch: dict, images: int) -> float:
    p, ws = arch["patch_size"], arch["window_size"]
    h = arch["img_size"] // p
    c = arch["embed_dim"]
    total = 2.0 * images * h * h * c * 3 * p * p
    for stage, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        w = min(ws, h)
        hp = -(-h // w) * w
        n, np_, t = h * h, hp * hp, w * w
        block = (2.0 * np_ * c * 3 * c        # qkv on the padded canvas
                 + 2 * 2.0 * np_ * t * c      # q k^T and p v, every head
                 + 2.0 * np_ * c * c          # proj
                 + 2 * 2.0 * n * c * int(arch["mlp_ratio"] * c))
        total += images * depth * block
        if stage < len(arch["depths"]) - 1:
            total += 2.0 * images * (n // 4) * 4 * c * 2 * c
            h, c = h // 2, c * 2
    return total


def tokens(arch: dict) -> int:
    """Patch tokens N the backbone emits."""
    h = arch["img_size"] // arch["patch_size"] // 2 ** (len(arch["depths"]) - 1)
    return h * h
