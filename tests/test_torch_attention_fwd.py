"""The launch geometry of the bf16 attention forward (kernels 3 and 6).

The CUDA wrappers pass ``packed_attention.fwd_geometry`` to the Hopper kernel
of ``csrc/attention_fwd_sm90.cuh``, which checks it and refuses a launch that
differs.  Here it is held for every T in 1..1100 at both head widths: the
row blocks cover every query row, the key tiles every key with the last one
read to a multiple of 16 (wgmma's N and k-step) and no further, all of a
short sequence's keys are in flight at once, and two blocks fit an SM's
shared memory.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import pytest

from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as tpa

SM_SHARED = 233472  # an H100 SM's shared memory; each block also reserves 1 KB


@pytest.mark.parametrize("head_dim", tpa.HEAD_DIMS)
def test_fwd_geometry_covers_every_row_and_key(head_dim):
    for t in range(1, 1101):
        geo = tpa.fwd_geometry(t, head_dim)
        rows = geo["rows"]
        assert rows == tpa.FWD_ROWS == 128
        assert (geo["row_blocks"] - 1) * rows < t <= geo["row_blocks"] * rows
        walk, tile, last = geo["walk_tiles"], geo["tile"], geo["last"]
        assert tile == tpa.FWD_WALK == 64 and last in (16, 32, 48, 64)
        left = t - (walk - 1) * tile  # keys in the last tile
        assert 1 <= left <= tile
        assert last % 16 == 0 and left <= last < left + 16


@pytest.mark.parametrize("head_dim", tpa.HEAD_DIMS)
def test_fwd_geometry_fits_two_blocks_an_sm(head_dim):
    tile_bytes = tpa.FWD_WALK * head_dim * 2
    for t in range(1, 1101):
        geo = tpa.fwd_geometry(t, head_dim)
        stages = geo["stages"]
        # every key tile in flight at once when there are at most four, so a
        # packed group of up to 256 tokens needs no refill; a tile's stage is
        # its index masked by 3, so the ring never wraps below four
        assert stages == min(geo["walk_tiles"], tpa.FWD_MAX_STAGES) and 1 <= stages <= 4
        assert geo["smem"] <= tpa.SMEM_LIMIT and 2 * (geo["smem"] + 1024) <= SM_SHARED
        # alignment slack, two q tiles, a k and a v tile a stage, then a
        # barrier for q and one a stage, and a release count a stage
        assert geo["smem"] == 1024 + tile_bytes * (2 + 2 * stages) + 8 * (1 + stages) + 4 * stages


def test_fwd_geometry_at_the_main_path_shapes():
    # ViT-Base/224: 197 tokens in two blocks of 128 rows, keys walked to 208
    # (three tiles and one of 16), all four tiles in flight
    assert tpa.fwd_geometry(197, 64) == {"row_blocks": 2, "rows": 128, "walk_tiles": 4,
                                         "tile": 64, "last": 16, "stages": 4, "smem": 83000}
    # ViT-Base/448: 785 tokens, 7 blocks, keys walked to 800
    assert tpa.fwd_geometry(785, 64) == {"row_blocks": 7, "rows": 128, "walk_tiles": 13,
                                         "tile": 64, "last": 32, "stages": 4, "smem": 83000}
    # ViT-Large/512: 1025 tokens, 9 blocks (the last with one row), keys to 1040
    assert tpa.fwd_geometry(1025, 64) == {"row_blocks": 9, "rows": 128, "walk_tiles": 17,
                                          "tile": 64, "last": 16, "stages": 4, "smem": 83000}
    # heads of 32 (the Swin packed shape's) take half the tile bytes; two
    # key tiles, both in flight
    assert tpa.fwd_geometry(98, 32)["smem"] == 1024 + 4096 * 6 + 8 * 3 + 4 * 2
