"""Launch geometry of the fused attention half's Hopper forward (kernel 4).

``attn_half.fwd_geometry`` is how the bf16 kernel
(``csrc/attn_half_fwd_sm90.cuh``) cuts its work: a group of windows a block
(three at C = 128, two at 256), one per consumer warpgroup, blocks walking
groups persistently, about one wave of one block an SM, the SM count a
parameter.  Its walk must reach every
(image, window) exactly once at Swin-Base's fused stages (batch 64 serving,
128 training) and at the edges (one image, one window, odd window counts,
windows of 4 and 8); a block's shared memory must fit an H100 at both widths
and be what the C side computes; each pair streams the weights through the
stages the producer issues.  The kernel itself runs only on the card
(test_torch_cuda.py).  No JAX: the geometry is the port's own.
"""

import numpy as np
import pytest
import torch

from ego_moment_cle_vit_tpu_torch.kernels import attn_half as tah

torch.set_num_threads(1)

SMEM_LIMIT = 232448  # what a block may use on an H100
H100_SMS = 132

# (C, heads, ws, Hp): both fused widths at windows of 4, 7 and 8; Hp of one
# window, an odd count of windows a side, and Swin-Base's stages 0 and 1
CASES = [(c, c // 32, ws, hp) for c in (128, 256)
         for ws, hps in ((4, (4, 12, 16)), (7, (7, 21, 28, 56)), (8, (8, 24)))
         for hp in hps]


def _walk(geo: dict) -> np.ndarray:
    """How many times the kernel's walk reaches each window: block i takes
    groups i, i + blocks, ...; group g holds windows k g .. k g + k - 1 for
    k windows a block (those past the end, which the kernel skips, on a
    count k does not divide)."""
    seen = np.zeros(geo["windows"], dtype=np.int64)
    k = geo["windows_per_block"]
    for block in range(geo["blocks"]):
        for group in range(block, geo["groups"], geo["blocks"]):
            for w in range(k * group, k * group + k):
                if w < geo["windows"]:
                    seen[w] += 1
    return seen


@pytest.mark.parametrize("batch", [1, 3, 64, 128])
@pytest.mark.parametrize("c, heads, ws, hp", CASES)
def test_fwd_geometry_walks_every_window_once(c, heads, ws, hp, batch):
    geo = tah.fwd_geometry(batch, hp, hp, c, heads, ws, H100_SMS)
    assert geo["windows"] == batch * (hp // ws) ** 2
    assert geo["windows_per_block"] == {128: 3, 256: 2}[c]
    assert geo["groups"] == -(-geo["windows"] // geo["windows_per_block"])
    assert (_walk(geo) == 1).all()
    # about one wave: every block has a group, none waits for an SM
    assert geo["blocks"] == min(geo["groups"], H100_SMS)


@pytest.mark.parametrize("c, heads, ws, hp", CASES)
def test_fwd_geometry_shared_memory_and_stages(c, heads, ws, hp):
    geo = tah.fwd_geometry(64, hp, hp, c, heads, ws, H100_SMS)
    # the C side's Traits<C>::kSmem: alignment slack; per window xn and om
    # [64][C] and q, k, v [64][32] in bf16; four 16 KB ring stages; a full
    # and an empty barrier a stage
    k = geo["windows_per_block"]
    want = 1024 + k * (2 * 64 * c * 2 + 3 * 64 * 32 * 2) + 4 * 128 * 64 * 2 + 16 * 4
    assert geo["smem"] == want and geo["smem"] <= SMEM_LIMIT and geo["stages"] == 4
    # a head's q, k, v product takes C / 64 stages, all in the ring at once
    assert geo["stages"] >= c // 64
    # the producer's stages a group: C / 64 for each head's q, k, v, and C /
    # 64 for each of the C / 128 proj passes
    assert geo["stages_per_group"] == (heads + c // 128) * (c // 64)


def test_fwd_geometry_at_the_main_path_shapes():
    stage0 = tah.fwd_geometry(64, 56, 56, 128, 4, 7, H100_SMS)
    assert (stage0["windows"], stage0["groups"], stage0["blocks"]) == (4096, 1366, 132)
    assert (stage0["stages_per_group"], stage0["smem"]) == (10, 201792)
    stage1 = tah.fwd_geometry(128, 28, 28, 256, 8, 7, H100_SMS)
    assert (stage1["windows"], stage1["groups"], stage1["blocks"]) == (2048, 1024, 132)
    assert (stage1["stages_per_group"], stage1["smem"]) == (40, 222272)


@pytest.mark.parametrize("sms", [1, 7, 114, 132, 5000])
def test_fwd_geometry_takes_the_sm_count_as_a_parameter(sms):
    geo = tah.fwd_geometry(64, 28, 28, 256, 8, 7, sms)
    assert geo["blocks"] == min(512, sms)
    assert (_walk(geo) == 1).all()
    geo = tah.fwd_geometry(64, 56, 56, 128, 4, 7, sms)
    assert geo["blocks"] == min(1366, sms)
    assert (_walk(geo) == 1).all()


def test_fwd_geometry_refuses_what_the_kernel_does_not_take():
    for args in ((1, 56, 56, 96, 3, 7), (1, 56, 56, 128, 2, 7), (1, 56, 56, 128, 4, 9),
                 (1, 50, 50, 128, 4, 7)):
        with pytest.raises(ValueError, match="the kernel takes"):
            tah.fwd_geometry(*args, H100_SMS)
