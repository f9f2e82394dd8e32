"""DINOv2 backbone FLOPs: patch convolution, per block the qkv and proj
products, attention, and the packed SwiGLU's two products (fc1 to twice the
hidden width, fc2 from it) over the CLS token, the registers and the
patches.  SiLU, the gate, LayerScale and the LayerNorms are elementwise and
not counted."""


def forward_flops(arch: dict, images: int) -> float:
    p, d, h = arch["patch_size"], arch["embed_dim"], arch["mlp_hidden"]
    n = tokens(arch)
    t = n + 1 + arch["num_registers"]
    block = 4 * 2.0 * t * d * d + 2 * 2.0 * t * t * d + 3 * 2.0 * t * d * h
    return images * (2.0 * n * d * 3 * p * p + arch["depth"] * block)


def tokens(arch: dict) -> int:
    return (arch["img_size"] // arch["patch_size"]) ** 2
