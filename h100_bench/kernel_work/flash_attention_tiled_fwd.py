"""Kernel 6, q-tiled attention forward: qkv read, the output written (and
each row's log-sum-exp in training); 4 T^2 d flops a head."""

from h100_bench.kernel_work import element_size

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.flash_attention:flash_attention_tiled_fwd"
SOURCE = "flash_attention_fwd"
SYMBOLS = r"(?<!window_)attention_fwd_sm90|::attention_fwd[<(]"


def work(spec: dict, batch: int, serving: bool) -> list:
    images = batch if serving else 2 * batch  # training runs both views as one batch
    arch = spec["architecture"]
    t = (arch["img_size"] // arch["patch_size"]) ** 2 + 1
    c, heads = arch["embed_dim"], arch["num_heads"]
    qkv = images * t * 3 * c
    nbytes = qkv * element_size(spec) * 4 / 3 + (0 if serving else images * heads * t * 4)
    return [(nbytes, 4.0 * images * heads * t * t * (c // heads))] * arch["depth"]
