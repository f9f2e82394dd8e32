"""Kernel 1b, window attention backward: qkv and dout read, dqkv written,
the bias table read and its gradient written, the mask read; 10 T^2 d flops
a window and head (the least the five products need)."""

from h100_bench.kernel_work import element_size, swin_stages

WRAPPER = "ego_moment_cle_vit_tpu_torch.kernels.window_attention:window_attention_bwd"
SOURCE = "window_attention_bwd"
SYMBOLS = r"window_attention_(bwd_sm90|bwd_f32|dbias_reduce)"


def work(spec: dict, batch: int, serving: bool) -> list:
    images = batch if serving else 2 * batch  # training runs both views as one batch
    es, out = element_size(spec), []
    for hp, c, heads, depth, shifted, ws, h in swin_stages(spec["architecture"]):
        nt, nw, d = ws * ws, (hp // ws) ** 2, c // heads
        qkv = images * hp * hp * 3 * c
        flops = 10.0 * images * nw * heads * nt * nt * d
        for blk in range(depth):
            masked = (blk % 2 == 1 and shifted) or hp != h
            nbytes = (2 * qkv + qkv // 3) * es + 2 * heads * nt * nt * 4 + (
                nw * nt * nt * 4 if masked else 0)
            out.append((nbytes, flops))
    return out
