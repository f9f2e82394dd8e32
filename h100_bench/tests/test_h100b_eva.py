"""EVA-02 in the benchmark, added as files: the family found by file
(``reference/families/eva.py``, ``flops/eva.py``, which import neither JAX
nor the program), the FLOP model against a
hand sum at EVA-02-L/448 and against ``FlopCounterMode`` on the program's
plain path at the micro size, the per-layer readers of its two spans, and a
tiny EVA cell (the micro backbone at 224 px: 257 tokens, N = 256 >= D = 128,
the dense route with its iSQRT output compared) run whole through
``kinds/serve`` on the CPU: correct as it stands, not with the rotary
embedding left out."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ego_moment_cle_vit_tpu_torch import create_model, make_infer_fn
from ego_moment_cle_vit_tpu_torch.data.augment import AugmentConfig
from ego_moment_cle_vit_tpu_torch.models import eva
from h100b_tiny import BENCH, ROOT, SEED, SWIN, TINY_ISQRT_LIMIT, TINY_LIMITS, _tiny_spec, tiny_root

from h100_bench import devtrace, flops, harness, program_spans
from h100_bench.flops.heads import heads_flops
from h100_bench.reference.model import RefModel

torch.set_num_threads(2)
EVA_L = json.loads((BENCH / "configs" / "eva02L14-448-flagship.json").read_text())
MICRO = _tiny_spec(
    "eva02L14-448-flagship.json", "eva-micro-dense",
    {"family": "eva", "backbone_name": "eva02_micro_patch14_56", "img_size": 224,
     "patch_size": 14, "embed_dim": 128, "depth": 2, "num_heads": 2, "mlp_hidden": 341,
     "rope_ref_grid": 4, "num_features": 128},
    {"resize_size": 232, "input_size": 224},
    {"serve": {"flash_attention_tiled_fwd": 2, "gpf_fwd": 1,
               "newton_schulz_isqrt_fp32_fwd": 1}})
CELL = "serve-eva-micro-dense"


def test_the_family_is_found_by_file():
    assert flops.family_of(EVA_L["architecture"]).__name__ == "h100_bench.flops.eva"
    with torch.device("meta"):
        ref = RefModel(EVA_L)
    assert ref.backbone.backbone.family.__name__ == "h100_bench.reference.families.eva"
    names = set(ref.state_dict())
    assert "backbone.backbone.eva.blocks_23.attn.k_proj.weight" in names
    assert "backbone.backbone.eva.blocks_23.attn.k_proj.bias" not in names
    assert "backbone.backbone.eva.blocks_23.mlp.norm.weight" in names
    # the configuration's widths are the registered backbone's
    cfg = eva.EVA_CONFIGS[EVA_L["architecture"]["backbone_name"]]
    arch = EVA_L["architecture"]
    assert (arch["embed_dim"], arch["depth"], arch["num_heads"], arch["mlp_hidden"],
            arch["patch_size"], arch["rope_ref_grid"], arch["img_size"]) == (
        cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.mlp_hidden, cfg.patch_size,
        cfg.rope_ref_grid, cfg.img_size)


def test_the_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, h100_bench.reference.families.eva, h100_bench.flops.eva; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "ego_moment_cle_vit_tpu",
                      "ego_moment_cle_vit_tpu_torch"}


def test_flops_against_a_hand_sum():
    """EVA-02-L at 448, an image: 1025 tokens; a block's q / k / v / proj
    4 x 2 T D^2 = 8.598 G, attention 2 x 2 T^2 D = 4.303 G, SwiGLU
    3 x 2 T D 2730 = 17.192 G; 24 blocks and the patch convolution
    2 x 1024 x 1024 x 588 = 1.233 G: 723.5 GFLOP."""
    arch = EVA_L["architecture"]
    family = flops.family_of(arch)
    assert family.tokens(arch) == 1024
    qkvo = 4 * 2 * 1025 * 1024 * 1024
    attn = 2 * 2 * 1025 * 1025 * 1024
    swiglu = 3 * 2 * 1025 * 1024 * 2730
    conv = 2 * 1024 * 1024 * 3 * 14 * 14
    assert (qkvo, attn, swiglu, conv) == (8_598_323_200, 4_303_360_000, 17_192_448_000,
                                          1_233_125_376)
    assert family.forward_flops(arch, 1) == 24 * (qkvo + attn + swiglu) + conv
    assert family.forward_flops(arch, 64) == pytest.approx(46.30e12, rel=1e-3)


def test_flops_against_the_counter_at_the_micro_size():
    """The program's plain path at batch 1, counted by torch (the plain GPF
    forms both Grams where serving needs one, as ``test_h100b_flops.py``
    counts it)."""
    spec, arch = MICRO, MICRO["architecture"]
    model = create_model(spec["port_config"], spec["num_classes"], device="cpu",
                         dtype=torch.float32).eval()
    n, d = flops.family_of(arch).tokens(arch), arch["num_features"]
    images = torch.randn(1, arch["img_size"], arch["img_size"], 3)
    mode = FlopCounterMode(display=False)
    with mode, torch.no_grad():
        model.inference(images)
    want = (flops.family_of(arch).forward_flops(arch, 1)
            + heads_flops(spec, 1, n, training=False) + 2 * n * n * d)
    assert mode.get_total_flops() == pytest.approx(want, rel=1e-9)


def test_span_readers_read_every_block():
    """The serving call records ``emct.rope`` and ``emct.swiglu`` once a
    block; their readers give a finite, non-negative figure (device time:
    none on the CPU) and None on a trace without them."""
    spec = MICRO
    model = create_model(spec["port_config"], 10, device="cpu")
    infer = make_infer_fn(model, AugmentConfig(**spec["input"]), device="cpu")
    s = spec["input"]["resize_size"]
    images = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8)
    steps, depth = 2, spec["architecture"]["depth"]
    trace = devtrace.Trace(devtrace.profile(lambda i: infer(images), steps), steps)
    ctx = harness.TracedRun(trace, [], 0.0, 0, 0.0, "cpu")
    for span in ("rope", "swiglu"):
        assert len(program_spans.ranges(trace, span)) == steps * depth
        value = harness.load_file(BENCH / "layer_metrics" / f"{span}_ms.serve.py").read(ctx)
        assert value is not None and math.isfinite(value) and value >= 0.0
    swin = create_model(SWIN["port_config"], 10, device="cpu")
    other = make_infer_fn(swin, AugmentConfig(**SWIN["input"]), device="cpu")
    s = SWIN["input"]["resize_size"]
    small = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8)
    without = devtrace.Trace(devtrace.profile(lambda i: other(small), 1), 1)
    ctx = harness.TracedRun(without, [], 0.0, 0, 0.0, "cpu")
    for span in ("rope", "swiglu"):
        assert harness.load_file(BENCH / "layer_metrics" / f"{span}_ms.serve.py").read(
            ctx) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the tiny EVA cell added as files."""
    root_dir, _ = tiny_root(tmp_path_factory.mktemp("eva"))
    bench = json.loads((root_dir / "BENCHMARK.json").read_text())
    path = f"h100_bench/configs/{MICRO['name']}.json"
    (root_dir / path).write_text(json.dumps(MICRO))
    bench["configs"].append({"name": MICRO["name"], "source": "https://example.org/tiny",
                             "file": path, "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": CELL, "config": MICRO["name"], "traffic": "serve-tiny",
                               "chips": 1, "why": "a CPU test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if any(w.startswith("serve-") for w in metric.get("workloads", [])):
            metric["workloads"].append(CELL)
    (root_dir / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root_dir / "h100_bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps({**TINY_LIMITS["serve"], **TINY_ISQRT_LIMIT}))
    return root_dir


def test_tiny_eva_cell_is_correct(root):
    cell = harness.load_cell(root, CELL)
    result, check = harness.run(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"], check
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(check) == {"logits_rel_l2", "isqrt_rel_l2"}
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_tiny_eva_cell_without_rope_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(eva, "apply_rope", lambda x, rope, num_heads: x)
    cell = harness.load_cell(root, CELL)
    result, check = harness.run(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], check
    assert check["logits_rel_l2"]["value"] > check["logits_rel_l2"]["limit"], check
