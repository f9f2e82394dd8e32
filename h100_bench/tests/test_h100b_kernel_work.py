"""The kernels' least work against the bound column of PERF.md's kernel
table (chip_smoke.py's arithmetic): kernel 1 0.477 ms a Swin-Base/224
serving forward, 1b 1.667 a training step, 2 0.0021 / 2b 0.0079 at
[64, 49, 1024], 6 1.470 a ViT-Base/448 forward, 6b 7.350 a step, the dense
route's Newton–Schulz 5 4.221 at [64, 768, 768] (fp32-accurate products at
the split's rate: six bf16 products each), 5′ 1.668 at
[64, 1024, 1024], 5″ 5.628 at [64, 1536, 1536], the subspace iSQRT 7 7.414
at [64, 784, 1024] and 0.044 (bytes) at [64, 49, 1024], all at k = 5."""

from __future__ import annotations

import importlib
import json

import pytest

from h100b_tiny import BENCH, ROOT

from h100_bench import harness
from h100_bench.flops import isqrt_products
from h100_bench.kernel_work import SPLIT_PRODUCTS, bound_s

SWIN_B = json.loads((BENCH / "configs" / "swinB-224-flagship.json").read_text())
VIT_B448 = {"architecture": {"family": "vit", "img_size": 448, "patch_size": 16,
                             "embed_dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4.0,
                             "num_features": 768},
            "port_config": {"model": {"bf16": True}}}
VIT_L448 = json.loads((BENCH / "configs" / "vitL16-448-multiscale.json").read_text())
VIT_L512 = {"architecture": {**VIT_L448["architecture"], "img_size": 512},
            "port_config": VIT_L448["port_config"]}
SWIN_L1280 = {"architecture": {"family": "swin", "img_size": 1280, "patch_size": 4,
                               "embed_dim": 192, "depths": [2, 2, 18, 2],
                               "num_heads": [6, 12, 24, 48], "window_size": 7,
                               "mlp_ratio": 4.0, "num_features": 1536},
              "port_config": SWIN_B["port_config"]}


@pytest.mark.parametrize("wrapper,spec,serving,ms", [
    ("window_attention_fwd", SWIN_B, True, "0.477"),
    ("window_attention_bwd", SWIN_B, False, "1.667"),
    ("gpf_fwd", SWIN_B, True, "0.0021"),
    ("gpf_bwd", SWIN_B, False, "0.0079"),
    ("flash_attention_tiled_fwd", VIT_B448, True, "1.470"),
    ("flash_attention_tiled_bwd", VIT_B448, False, "7.350"),
    ("newton_schulz_isqrt_fp32_fwd", VIT_B448, True, "4.221"),
    ("newton_schulz_isqrt_bf16_fwd", VIT_L512, True, "1.668"),
    ("newton_schulz_isqrt_bf16_streamed_fwd", SWIN_L1280, True, "5.628"),
    ("subspace_isqrt_fwd", VIT_L448, True, "7.414"),
    ("subspace_isqrt_fwd", SWIN_B, True, "0.044"),
])
def test_bound_matches_the_kernel_table(wrapper, spec, serving, ms):
    mod = importlib.import_module(f"h100_bench.kernel_work.{wrapper}")
    dtype = getattr(mod, "DTYPE", "bfloat16")
    total = sum(bound_s(b, f, dtype) for b, f in mod.work(spec, 64, serving)) * 1e3
    # the table's figure, to the digits it gives
    assert f"{total:.{len(ms.split('.')[1])}f}" == ms


def test_fp32_accurate_kernels_are_held_to_one_rule():
    """serve-vitB-448-b64 is a bf16 model whose kernel 5 keeps its products
    fp32-accurate: they count six bf16 products each at the bf16 peak, as
    kernel 7's do, and not the fp32 SIMT peak (10.38 ms), which kernel 7
    already runs past."""
    cell = harness.load_cell(ROOT, "serve-vitB-448-b64")
    bounds = {k.wrapper: k.bound_s_per_step * 1e3 for k in harness.kernel_work(cell)}
    assert f"{bounds['newton_schulz_isqrt_fp32_fwd']:.3f}" == "4.221"
    assert f"{bounds['flash_attention_tiled_fwd']:.3f}" == "1.470"
    fp32_peak = sum(bound_s(b, f / SPLIT_PRODUCTS, "float32") for b, f in
                    harness.kernel_module("newton_schulz_isqrt_fp32_fwd").work(
                        cell.spec, 64, True))
    assert f"{fp32_peak * 1e3:.2f}" == "10.38"


@pytest.mark.parametrize("route,k,least,products", [
    ("dense", 5, False, 15), ("dense", 5, True, 12),
    ("subspace", 5, False, 25), ("subspace", 5, True, 17)])
def test_one_count_of_the_iterations_products(route, k, least, products):
    """flops/heads.py (the model's count) and kernel_work/ (the least) take
    the iSQRT's products from one helper."""
    assert isqrt_products(route, k, least) == products


@pytest.mark.parametrize("wrapper", sorted(p.stem for p in (BENCH / "kernel_work").glob("*.py")
                                           if p.stem != "__init__"))
def test_wrapper_and_source_exist(wrapper):
    mod = importlib.import_module(f"h100_bench.kernel_work.{wrapper}")
    module, fn = mod.WRAPPER.split(":")
    assert hasattr(getattr(importlib.import_module(module), fn), "launches")
    assert (BENCH.parent / "ego_moment_cle_vit_tpu_torch" / "csrc" / f"{mod.SOURCE}.cu").exists()
