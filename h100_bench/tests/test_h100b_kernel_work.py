"""The kernels' least work against the bound column of PERF.md's kernel
table (chip_smoke.py's arithmetic): kernel 1 0.477 ms a Swin-Base/224
serving forward, 1b 1.667 a training step, 2 0.0021 / 2b 0.0079 at
[64, 49, 1024], 6 1.470 a ViT-Base/448 forward, 6b 7.350 a step."""

from __future__ import annotations

import importlib
import json

import pytest

from h100b_tiny import BENCH

from h100_bench.kernel_work import bound_s

SWIN_B = json.loads((BENCH / "configs" / "swinB-224-flagship.json").read_text())
VIT_B448 = {"architecture": {"family": "vit", "img_size": 448, "patch_size": 16,
                             "embed_dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4.0,
                             "num_features": 768},
            "port_config": {"model": {"bf16": True}}}


@pytest.mark.parametrize("wrapper,spec,serving,ms", [
    ("window_attention_fwd", SWIN_B, True, "0.477"),
    ("window_attention_bwd", SWIN_B, False, "1.667"),
    ("gpf_fwd", SWIN_B, True, "0.0021"),
    ("gpf_bwd", SWIN_B, False, "0.0079"),
    ("flash_attention_tiled_fwd", VIT_B448, True, "1.470"),
    ("flash_attention_tiled_bwd", VIT_B448, False, "7.350"),
])
def test_bound_matches_the_kernel_table(wrapper, spec, serving, ms):
    mod = importlib.import_module(f"h100_bench.kernel_work.{wrapper}")
    total = sum(bound_s(b, f, "bfloat16") for b, f in mod.work(spec, 64, serving)) * 1e3
    # the table's figure, to the digits it gives
    assert f"{total:.{len(ms.split('.')[1])}f}" == ms


@pytest.mark.parametrize("wrapper", ["window_attention_fwd", "window_attention_bwd", "gpf_fwd",
                                     "gpf_bwd", "flash_attention_tiled_fwd",
                                     "flash_attention_tiled_bwd"])
def test_wrapper_and_source_exist(wrapper):
    mod = importlib.import_module(f"h100_bench.kernel_work.{wrapper}")
    module, fn = mod.WRAPPER.split(":")
    assert hasattr(getattr(importlib.import_module(module), fn), "launches")
    assert (BENCH.parent / "ego_moment_cle_vit_tpu_torch" / "csrc" / f"{mod.SOURCE}.cu").exists()
