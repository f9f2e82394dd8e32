"""The window-attention forward (kernel 1): the Hopper kernel's launch
geometry and the plain version on a padded canvas.

``window_attention.fwd_geometry`` is how the bf16 kernel
(``csrc/window_attention_fwd_sm90.cuh``) cuts its work: one block per
(window position, head) walking a chunk of images.  Its grid must cover every
(image, window, head) exactly once, with no chunk empty, at every Swin-Base
and Swin-Large stage the port runs (224 and 1280, the latter on its padded
canvases) and at batches that do not divide into the chunks; its TMA strides
must be multiples of 16 bytes and its shared memory must let the blocks an
SM it claims share one H100 SM.  The kernel itself runs only on the card
(test_torch_cuda.py).

The plain version is also held against the JAX package's
``flash_window_attention_spatial`` in interpret mode on a canvas padded from
12 to 14 rows, whose masks carry the -100 pad sentinel (shifted and not):
fp32, 2e-5 absolute, as ``test_torch_kernels.py`` holds it unpadded.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ego_moment_cle_vit_tpu.models.swin import _attn_mask as j_attn_mask
from ego_moment_cle_vit_tpu.models.swin import _blockdiag_mask, _build_bias_bd
from ego_moment_cle_vit_tpu.ops.pallas.window_attention import flash_window_attention_spatial
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as twa
from ego_moment_cle_vit_tpu_torch.models.swin import (
    SWIN_CONFIGS,
    _attn_mask,
    _relative_position_index,
)

torch.set_num_threads(1)

WS = 7
SM_SMEM = 233472  # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # what the card sets aside a block
H100_SMS = 132  # the SM count the wrapper reads from an H100


def _canvases(image: int) -> list[int]:
    """The padded canvas of each Swin stage at ``image`` pixels (patch 4,
    halved per stage, padded up to a multiple of the window)."""
    side, out = image // 4, []
    for _ in range(4):
        out.append(-(-side // WS) * WS)
        side //= 2
    return out


# (model, input size): every Swin stage the port serves or trains
STAGES = sorted({(hp, cfg.embed_dim * 2 ** i, cfg.num_heads[i])
                 for name, image in (("swin_base_patch4_window7_224", 224),
                                     ("swin_large_patch4_window7_224", 1280))
                 for cfg in (SWIN_CONFIGS[name],)
                 for i, hp in enumerate(_canvases(image))})


def test_stages_are_the_ones_the_port_runs():
    # Swin-Base/224: 56, 28, 14, 7; Swin-Large/1280: 320, 160, 80, 40 padded
    assert [s[0] for s in STAGES] == [7, 14, 28, 42, 56, 84, 161, 322]
    assert (322, 192, 6) in STAGES and (7, 1024, 32) in STAGES


@pytest.mark.parametrize("batch", [1, 5, 8, 64, 100, 128])
@pytest.mark.parametrize("hp, c, heads", STAGES)
def test_fwd_geometry_covers_each_window_once(hp, c, heads, batch):
    geo = twa.fwd_geometry(batch, hp, hp, c, heads, WS, H100_SMS)
    n_win = (hp // WS) ** 2
    assert geo["windows"] == n_win and geo["pairs"] == n_win * heads
    per, chunks = geo["images_per_block"], geo["chunks"]
    assert geo["blocks"] == geo["pairs"] * chunks
    # the kernel's walk: block (pair, chunk) takes images [chunk * per, ...)
    seen = np.zeros((batch, n_win, heads), dtype=np.int64)
    for chunk in range(chunks):
        lo, hi = chunk * per, min(batch, chunk * per + per)
        assert hi > lo, "a chunk is empty"
        for pair in range(geo["pairs"]):
            seen[lo:hi, pair // heads, pair % heads] += 1
    assert (seen == 1).all()
    # about one wave of blocks on an H100 (one chunk where the pairs alone
    # fill it), never more chunks than images
    slots = twa.FWD_BLOCKS_PER_SM * H100_SMS
    assert chunks <= batch
    assert geo["blocks"] <= max(slots, geo["pairs"])
    assert 2 * geo["blocks"] > min(slots, geo["pairs"] * batch)


@pytest.mark.parametrize("hp, c, heads", STAGES)
def test_fwd_geometry_tma_strides_and_shared_memory(hp, c, heads):
    geo = twa.fwd_geometry(64, hp, hp, c, heads, WS, H100_SMS)
    row, line, image = geo["tma_strides"]
    assert row == 3 * c * 2 and line == row * hp and image == line * hp
    assert all(s % 16 == 0 for s in geo["tma_strides"])
    # the C side's smem_bytes: alignment slack, q/k/v tiles of 64 x 32 bf16 and
    # a barrier a stage, one fp32 logit term per thread and accumulator entry
    stages = geo["stages"]
    assert geo["smem"] == 1024 + stages * (3 * 64 * 32 * 2 + 8) + 128 * 32 * 4
    assert 1 <= stages <= 4 and geo["smem"] <= 232448
    assert geo["blocks_per_sm"] * (geo["smem"] + BLOCK_RESERVED) <= SM_SMEM


def test_fwd_geometry_walks_many_images_where_windows_are_many():
    # Swin-Large/1280 stage 0: 2116 windows x 6 heads fill the card with one
    # chunk; Swin-Base stage 3 (one window, 32 heads) takes 16 chunks of 4
    big = twa.fwd_geometry(64, 322, 322, 192, 6, WS, H100_SMS)
    assert big["chunks"] == 1 and big["images_per_block"] == 64
    small = twa.fwd_geometry(64, 7, 7, 1024, 32, WS, H100_SMS)
    assert small["chunks"] == 16 and small["images_per_block"] == 4


def _port_bias(table: np.ndarray) -> torch.Tensor:
    nt = WS * WS
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1))
    t = torch.from_numpy(table)
    return t[idx].reshape(nt, nt, table.shape[1]).permute(2, 0, 1).contiguous()


@pytest.mark.parametrize("shift", [0, WS // 2])
def test_window_attention_plain_matches_pallas_on_a_padded_canvas(shift):
    h, hp, c, heads, mm = 12, 14, 128, 4, 2
    rng = np.random.default_rng(11 + shift)
    qkv = rng.normal(size=(2, hp, hp, 3 * c)).astype(np.float32)
    table = rng.normal(size=((2 * WS - 1) ** 2, heads)).astype(np.float32)
    mask = _attn_mask(h, h, hp, hp, WS, shift)
    assert mask is not None and (mask == -100.0).any()  # the pad sentinel
    scale = (c // heads) ** -0.5
    jm = j_attn_mask(h, h, hp, hp, WS, shift)
    np.testing.assert_array_equal(mask, np.asarray(jm))
    ref = flash_window_attention_spatial(
        jnp.asarray(qkv), _build_bias_bd(jnp.asarray(table), WS, mm, heads),
        _blockdiag_mask(jnp.asarray(jm), mm), heads, WS, 2, mm, scale)
    out = twa.window_attention_plain(torch.from_numpy(qkv), _port_bias(table),
                                     torch.from_numpy(mask), heads, WS, scale)
    assert out.shape == (2, hp, hp, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    # the check has power: without the pad sentinel real queries see pad keys
    unpadded = twa.window_attention_plain(
        torch.from_numpy(qkv), _port_bias(table),
        None if shift == 0 else torch.from_numpy(_attn_mask(hp, hp, hp, hp, WS, shift)),
        heads, WS, scale)
    assert np.abs(unpadded.numpy() - np.asarray(ref)).max() > 1e-2
