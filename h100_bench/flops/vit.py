"""ViT backbone FLOPs: patch convolution, per block qkv / attention / proj /
MLP over the CLS token and the patches."""


def forward_flops(arch: dict, images: int) -> float:
    p, d = arch["patch_size"], arch["embed_dim"]
    n = (arch["img_size"] // p) ** 2
    t = n + 1
    block = (2.0 * t * d * 3 * d + 2 * 2.0 * t * t * d + 2.0 * t * d * d
             + 2 * 2.0 * t * d * int(arch["mlp_ratio"] * d))
    return images * (2.0 * n * d * 3 * p * p + arch["depth"] * block)


def tokens(arch: dict) -> int:
    return (arch["img_size"] // arch["patch_size"]) ** 2
