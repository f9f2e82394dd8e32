"""The GPF forward (kernel 2): the Hopper kernel's triangular tile schedule
and launch geometry, and the plain version at a tile edge.

The bf16 kernel (``csrc/gpf_fwd_sm90.cuh``) gives each block one output tile
of the upper triangle, in the order of ``gpf.fwd_tile_pairs``, and has the
block write that tile and, off the diagonal, its mirror.  A Python mirror of
the kernel's walk from block index to tile must give that order, and the
tiles written must cover every entry of the [N, N] output exactly once, for
every N the wrappers admit and past it (1 ... 1700).  ``gpf.fwd_geometry``'s
shared memory must hold the ring and, after it, the epilogue's fp32 tiles,
and must let the blocks an SM it claims share one H100 SM.  The kernel
itself runs only on the card (test_torch_cuda.py).

The plain version is held against the JAX package's ``fused_gpf_pallas`` at
N = 129 (one past two 64-token tiles, one past a 128-token tile), one tensor
twice and two, within 1e-4 of ``gpf_error_scale`` per entry, as
``test_torch_kernels.py`` holds it at 49.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ego_moment_cle_vit_tpu.ops.pallas.gpf import fused_gpf_pallas
from ego_moment_cle_vit_tpu_torch.kernels import gpf as tgpf

torch.set_num_threads(1)

SM_SMEM = 233472  # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # what the card sets aside a block


def _kernel_walk(block: int, tiles: int) -> tuple[int, int]:
    """The kernel's map from a block's index to its (row tile, column tile),
    line for line."""
    it, rem = 0, block
    while rem >= tiles - it:
        rem -= tiles - it
        it += 1
    return it, it + rem


def test_triangle_walk_covers_every_tile_once_for_every_n():
    for n in range(1, 1701):
        for same in (True, False):
            geo = tgpf.fwd_geometry(n, same)
            tiles, tile = geo["tiles"], geo["tile"]
            assert tiles == -(-n // tile) and geo["pairs"] == tiles * (tiles + 1) // 2
            pairs = tgpf.fwd_tile_pairs(tiles)
            assert [_kernel_walk(b, tiles) for b in range(geo["pairs"])] == pairs
            # each block writes its tile and, off the diagonal, the mirror
            written = np.zeros((tiles, tiles), dtype=np.int64)
            for it, jt in pairs:
                assert it <= jt
                written[it, jt] += 1
                if it != jt:
                    written[jt, it] += 1
            assert (written == 1).all(), n


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 196, 256, 257, 784, 1024, 1600])
def test_triangle_walk_covers_every_entry_once(n):
    """The same at the entries, with the kernel's guards: rows and columns
    past N are never stored."""
    geo = tgpf.fwd_geometry(n, True)
    tile = geo["tile"]
    written = np.zeros((n, n), dtype=np.int64)
    for it, jt in tgpf.fwd_tile_pairs(geo["tiles"]):
        rows = slice(it * tile, min(n, it * tile + tile))
        cols = slice(jt * tile, min(n, jt * tile + tile))
        written[rows, cols] += 1
        if it != jt:
            written[cols, rows] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("n", [1, 49, 196, 256, 257, 784, 1024, 1600])
def test_fwd_geometry_fits_the_card(n, same):
    geo = tgpf.fwd_geometry(n, same)
    wide = n >= tgpf.FWD_WIDE_FROM
    assert geo["tile"] == (128 if wide else 64)
    sets = 1 if same else 2
    stage = 2 * sets * geo["tile"] * 64 * 2
    # the C side's Shape::bytes: alignment slack, the stages, two barriers a stage
    assert geo["smem"] == 1024 + geo["stages"] * stage + 16 * geo["stages"]
    assert geo["smem"] <= tgpf.SMEM_LIMIT
    # the epilogue's [tile][tile + 1] fp32 tiles, one a set, fit in the ring
    assert geo["epilogue_bytes"] == sets * geo["tile"] * (geo["tile"] + 1) * 4
    assert geo["epilogue_bytes"] <= geo["stages"] * stage
    static = 2 * 2 * geo["tile"] * 4  # the clamped norms, rows and columns of each set
    assert geo["blocks_per_sm"] * (geo["smem"] + static + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("similarity", ["dot", "cosine"])
@pytest.mark.parametrize("same", [True, False])
def test_gpf_plain_matches_pallas_at_a_tile_edge(similarity, same):
    rng = np.random.default_rng(129)
    ta = rng.normal(size=(2, 129, 48)).astype(np.float32)
    tp = ta if same else rng.normal(size=(2, 129, 48)).astype(np.float32)
    coeffs = np.log1p(np.exp(rng.uniform(0, 0.1, size=(3, 3)))).astype(np.float32)
    ref = np.asarray(fused_gpf_pallas(jnp.asarray(ta), jnp.asarray(tp), jnp.asarray(coeffs),
                                      similarity, 1e-6, True))
    args = (torch.from_numpy(ta), torch.from_numpy(tp), torch.from_numpy(coeffs), similarity,
            1e-6, True)
    out = tgpf.gpf_plain(*args)
    assert out.dtype == torch.float32 and out.shape == (2, 129, 129)
    scale = tgpf.gpf_error_scale(*args).numpy()
    assert (np.abs(out.numpy() - ref) <= 1e-4 * scale).all()
    # the check has power: the last row and column (the tile edge) zeroed fail it
    edge = out.numpy().copy()
    edge[:, -1, :] = 0.0
    edge[:, :, -1] = 0.0
    assert not (np.abs(edge - ref) <= 1e-4 * scale).all()
