"""EVA-02 backbone FLOPs: patch convolution, per block the q / k / v / proj
products, attention, and the SwiGLU's three products (fc1_g, fc1_x, fc2)
over the CLS token and the patches.  The rotary embedding, SiLU, the gate
and the LayerNorms are elementwise and not counted."""


def forward_flops(arch: dict, images: int) -> float:
    p, d, h = arch["patch_size"], arch["embed_dim"], arch["mlp_hidden"]
    n = tokens(arch)
    t = n + 1
    block = 4 * 2.0 * t * d * d + 2 * 2.0 * t * t * d + 3 * 2.0 * t * d * h
    return images * (2.0 * n * d * 3 * p * p + arch["depth"] * block)


def tokens(arch: dict) -> int:
    return (arch["img_size"] // arch["patch_size"]) ** 2
