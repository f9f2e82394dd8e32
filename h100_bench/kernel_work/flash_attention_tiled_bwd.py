"""Kernel 6b, q-tiled attention backward: qkv, the output, its gradient and
the log-sum-exp read, dqkv written; 10 T^2 d flops a head (the least the
five products need)."""

from h100_bench.kernel_work import element_size

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.flash_attention:flash_attention_tiled_bwd"
SOURCE = "flash_attention_bwd"
SYMBOLS = r"attention_bwd_(dq|dkv)(_sm90)?[<(]"


def work(spec: dict, batch: int, serving: bool) -> list:
    images = batch if serving else 2 * batch  # training runs both views as one batch
    arch = spec["architecture"]
    t = (arch["img_size"] // arch["patch_size"]) ** 2 + 1
    c, heads = arch["embed_dim"], arch["num_heads"]
    qkv, out = images * t * 3 * c, images * t * c
    nbytes = (2 * qkv + 2 * out) * element_size(spec) + images * heads * t * 4
    return [(nbytes, 10.0 * images * heads * t * t * (c // heads))] * arch["depth"]
