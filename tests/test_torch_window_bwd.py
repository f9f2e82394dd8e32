"""Launch geometry of the Hopper window-attention backward (kernel 1b) and of
the fused attention half's backward (kernel 4b), on the CPU.

The bf16 kernels (``csrc/window_attention_bwd_sm90.cuh``,
``csrc/attn_half_bwd_sm90.cuh``) run only on the card; what they are handed
is computed here in Python and checked by the C entry points.  These tests
hold that geometry for every Swin stage of the registry, at 224 and on the
padded canvases of a 1280 input, and for every window size the kernels take:
every (image, window, head) is one block's work exactly once, no image or
token chunk is empty, every TMA stride is a multiple of 16 bytes, and each
launch fits an H100's shared memory (three or two blocks an SM where the
design says so).  No JAX here: the plain versions are held to the Pallas kernels in
``test_torch_kernels.py`` and ``test_torch_attn_half.py``.
"""

import numpy as np
import pytest
import torch

from ego_moment_cle_vit_tpu_torch.kernels import attn_half as tah
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as twa
from ego_moment_cle_vit_tpu_torch.models.swin import SWIN_CONFIGS

SMEM_BLOCK = 232448  # what one block may use on an H100
SMEM_SM = 233472  # an SM's shared memory, 1 KB of it reserved per block


def _stages(img_sizes=(224, 1280)):
    """(Hp, C, heads, ws) of every stage of every registered Swin at these
    inputs, canvases padded to the window as the model pads them."""
    out = set()
    for cfg in SWIN_CONFIGS.values():
        for img in img_sizes:
            for i, heads in enumerate(cfg.num_heads):
                h = img // cfg.patch_size // 2 ** i
                ws = cfg.window_size
                out.add((-(-h // ws) * ws, cfg.embed_dim * 2 ** i, heads, ws))
    return sorted(out)


STAGES = _stages()
# every window size the kernel takes, on canvases of 1-3 windows a side, at
# two and at many heads
WINDOWS = [(ws * n, 32 * heads, heads, ws) for ws in range(1, 9) for n in (1, 3)
           for heads in (2, 24)]


def _cover(geo, b):
    """How many times each (image, window, head) is some block's work."""
    count = np.zeros((b, geo["windows"], geo["pairs"] // geo["windows"]), np.int64)
    per = geo["images_per_block"]
    for chunk in range(geo["chunks"]):
        imgs = range(chunk * per, min(b, (chunk + 1) * per))
        assert len(imgs) > 0, "an empty image chunk"
        for pair in range(geo["pairs"]):
            count[list(imgs), pair // count.shape[2], pair % count.shape[2]] += 1
    return count


@pytest.mark.parametrize("hp, c, heads, ws", STAGES + WINDOWS)
@pytest.mark.parametrize("b", [1, 5, 128])
def test_window_bwd_geometry_covers_every_image_window_and_head_once(b, hp, c, heads, ws):
    for dtype in (torch.bfloat16, torch.float32):
        geo = twa.bwd_geometry(b, hp, hp, c, heads, ws, dtype)
        assert geo["windows"] == (hp // ws) ** 2 and geo["pairs"] == geo["windows"] * heads
        assert geo["blocks"] == geo["pairs"] * geo["chunks"]
        assert (_cover(geo, b) == 1).all()


@pytest.mark.parametrize("hp, c, heads, ws", STAGES + WINDOWS)
def test_window_bwd_geometry_keeps_tma_strides_aligned_and_fits(hp, c, heads, ws):
    geo = twa.bwd_geometry(128, hp, hp, c, heads, ws)
    strides = geo["tma_strides"]
    assert len(strides) == 6  # qkv and dout maps, three strides each
    assert all(s % 16 == 0 and 0 < s < 2**40 for s in strides)
    assert twa.HEAD_DIM * 2 == 64  # the box's inner extent, one 64-byte swizzle span
    assert ws <= twa.MAX_WINDOW and ws * ws <= 64  # the box's other extents; a 64-row tile
    assert geo["stages"] >= 1
    assert geo["smem"] <= SMEM_BLOCK and 3 * (geo["smem"] + 1024) <= SMEM_SM  # three blocks an SM
    fp32 = twa.bwd_geometry(128, hp, hp, c, heads, ws, torch.float32)
    assert fp32["stages"] == 0 and fp32["smem"] == 0 and fp32["tma_strides"] == ()


def test_window_bwd_geometry_at_the_main_path_shapes():
    """Swin-Base/224 at batch 128: 512 blocks of 8-64 images, a ring of two."""
    for hp, c, heads in ((56, 128, 4), (28, 256, 8), (14, 512, 16), (7, 1024, 32)):
        geo = twa.bwd_geometry(128, hp, hp, c, heads, 7)
        assert geo["blocks"] == 512 and geo["stages"] == 2 and geo["smem"] == 66576
    # the fp32 path keeps its chunks (its results stay the same bits)
    assert twa.bwd_geometry(128, 56, 56, 128, 4, 7, torch.float32)["chunks"] == \
        twa._bwd_chunks(128, 256)


FUSED = [(128, 56, 128, 4), (128, 28, 256, 8), (64, 56, 128, 4), (3, 21, 128, 4),
         (1, 7, 256, 8), (2, 14, 128, 4), (5, 35, 256, 8)]


@pytest.mark.parametrize("b, hp, c, heads", FUSED)
def test_attn_half_bwd_geometry_covers_every_token_once_and_fits(b, hp, c, heads):
    m, n_win = b * hp * hp, (hp // 7) ** 2
    geo = tah.bwd_geometry(b, m, c, n_win, heads)
    # weight gradients: chunks of 64-token tiles, each token in one chunk
    row_tiles = -(-m // 64)
    per = -(-row_tiles // geo["w_chunks"])
    owners = np.zeros(row_tiles, np.int64)
    for chunk in range(geo["w_chunks"]):
        tiles = range(chunk * per, min(row_tiles, (chunk + 1) * per))
        assert len(tiles) > 0, "an empty token chunk"
        owners[list(tiles)] += 1
    assert (owners == 1).all()
    assert geo["w_tiles"] == 4 * (c // 128) ** 2  # [128][128] tiles of dwqkv and dwproj
    # dx: tiles of whole rows (128 of them at C = 128, 64 at 256) walked by
    # at most one block an SM, each tile by one block
    assert geo["dx_tiles"] == -(-m // (128 if c == 128 else 64))
    assert 1 <= geo["dx_blocks"] <= min(geo["dx_tiles"], tah.SMS)
    walked = sorted(t for blk in range(geo["dx_blocks"])
                    for t in range(blk, geo["dx_tiles"], geo["dx_blocks"]))
    assert walked == list(range(geo["dx_tiles"]))
    assert geo["m_tiles"] == -(-m // 128)
    # qkv and do: [128][128] output tiles of [M, 4C], walked by at most one
    # block an SM, each tile by one block
    n_tiles = geo["m_tiles"] * 4 * c // 128
    assert 1 <= geo["qkv_blocks"] <= min(n_tiles, tah.SMS)
    walked = sorted(t for blk in range(geo["qkv_blocks"])
                    for t in range(blk, n_tiles, geo["qkv_blocks"]))
    assert walked == list(range(n_tiles))
    # the attention core: the window-attention backward's own geometry
    core = twa.bwd_geometry(b, hp, hp, c, heads, 7)
    assert geo["attn_chunks"] == core["chunks"] and geo["attn_stages"] == core["stages"]
    assert geo["smem"]["attention"] == core["smem"]
    for launch, two_an_sm in (("qkv", False), ("dx", False), ("wgrad", True), ("attention", True)):
        smem = geo["smem"][launch]
        assert smem <= SMEM_BLOCK
        assert not two_an_sm or 2 * (smem + 1024) <= SMEM_SM, launch


def _old_scratch(b, hp, c, heads):
    """What the backward's scratch took before its Hopper kernels: xn, om,
    dqkv in bf16 and the fp32 partials of 64 x 64 weight tiles, 2048 per-head
    attention blocks and at most 1024 dx blocks."""
    m, n_win = b * hp * hp, (hp // 7) ** 2
    row_tiles = -(-m // 64)
    attn = tah._chunks(b, 2048, n_win * heads)
    w = tah._chunks(row_tiles, 1024, (3 * c // 64) * (c // 64) + (c // 64) ** 2)
    return (m * 5 * c * 2 + attn * n_win * heads * 49 * 49 * 4 + w * (4 * c * c + 4 * c) * 4
            + min(row_tiles, 1024) * 2 * c * 4)


@pytest.mark.parametrize("b, hp, c, heads", FUSED[:2])
def test_attn_half_bwd_scratch_does_not_grow(b, hp, c, heads):
    """At both fused stages of a Swin-Base step (551 and 295 MB before)."""
    x = torch.empty(b, hp, hp, c, dtype=torch.bfloat16, device="meta")
    new = sum(tah.scratch_bytes(x, heads, 7).values())
    old = _old_scratch(b, hp, c, heads)
    assert round(old / 1e6) == (551 if c == 128 else 296)
    assert new <= old
