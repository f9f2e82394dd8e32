"""DINOv2 with registers in the benchmark, added as files: the family found
by file (``reference/families/dinov2.py``, ``flops/dinov2.py``, which import
neither JAX nor the program), the FLOP model against a hand sum at
ViT-g/14 at 518 and against ``FlopCounterMode`` on the program's plain path
at the micro size, the per-layer readers of its two spans, and a tiny
DINOv2 cell (the micro backbone at 56 px: CLS, 4 registers and 16 patches,
N = 16 < D = 128, the token-subspace route) run whole through
``kinds/serve`` on the CPU: correct as it stands, not with LayerScale left
out."""

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
from ego_moment_cle_vit_tpu_torch.models import vit
from h100b_tiny import BENCH, ROOT, SEED, SWIN, TINY_LIMITS, _tiny_spec, tiny_root

from h100_bench import devtrace, flops, harness, program_spans
from h100_bench.flops.heads import heads_flops
from h100_bench.reference.model import RefModel

torch.set_num_threads(2)
GIANT = json.loads((BENCH / "configs" / "dinov2g14-reg4-518-flagship.json").read_text())
MICRO = _tiny_spec(
    "dinov2g14-reg4-518-flagship.json", "dinov2-micro",
    {"family": "dinov2", "backbone_name": "vit_micro_patch14_reg4_dinov2", "img_size": 56,
     "patch_size": 14, "embed_dim": 128, "depth": 2, "num_heads": 2, "mlp_hidden": 341,
     "num_registers": 4, "num_features": 128},
    {"resize_size": 64, "input_size": 56},
    {"serve": {"gpf_fwd": 1, "subspace_isqrt_fwd": 1}})
CELL = "serve-dinov2-micro"


def test_the_family_is_found_by_file():
    assert flops.family_of(GIANT["architecture"]).__name__ == "h100_bench.flops.dinov2"
    with torch.device("meta"):
        ref = RefModel(GIANT)
    assert ref.backbone.backbone.family.__name__ == "h100_bench.reference.families.dinov2"
    shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    net = "backbone.backbone.vit."
    assert shapes[net + "pos_embed"] == (1, 1369, 1536)
    assert shapes[net + "reg_token"] == (1, 4, 1536)
    assert shapes[net + "blocks_39.mlp.fc1.weight"] == (8192, 1536)
    assert shapes[net + "blocks_39.mlp.fc2.weight"] == (1536, 4096)
    assert shapes[net + "blocks_39.ls1.gamma"] == shapes[net + "blocks_39.ls2.gamma"] == (1536,)
    assert net + "blocks_40.norm1.weight" not in shapes
    # the configuration's widths are the registered backbone's
    cfg = vit.DINOV2_CONFIGS[GIANT["architecture"]["backbone_name"]]
    arch = GIANT["architecture"]
    assert (arch["embed_dim"], arch["depth"], arch["num_heads"], arch["mlp_hidden"],
            arch["patch_size"], arch["num_registers"], arch["img_size"]) == (
        cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.swiglu_hidden, cfg.patch_size,
        cfg.num_registers, cfg.img_size)
    assert cfg.no_embed_class and cfg.layer_scale == 1e-5


def test_the_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, h100_bench.reference.families.dinov2, h100_bench.flops.dinov2; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "ego_moment_cle_vit_tpu",
                      "ego_moment_cle_vit_tpu_torch"}


def test_flops_against_a_hand_sum():
    """ViT-g/14 at 518, an image: 1374 tokens (CLS, 4 registers, 1369
    patches); a block's qkv / proj 4 x 2 T D^2 = 25.93 G, attention
    2 x 2 T^2 D = 11.60 G, the SwiGLU's fc1 (to 8192) and fc2 (from 4096)
    3 x 2 T D 4096 = 51.87 G; 40 blocks and the patch convolution
    2 x 1369 x 1536 x 588 = 2.473 G: 3.578 TFLOP, 229.0 a batch of 64."""
    arch = GIANT["architecture"]
    family = flops.family_of(arch)
    assert family.tokens(arch) == 1369
    qkvo = 4 * 2 * 1374 * 1536 * 1536
    attn = 2 * 2 * 1374 * 1374 * 1536
    swiglu = 2 * 1374 * 1536 * 8192 + 2 * 1374 * 4096 * 1536
    conv = 2 * 1369 * 1536 * 3 * 14 * 14
    assert (qkvo, attn, swiglu, conv) == (25_933_381_632, 11_599_110_144, 51_866_763_264,
                                          2_472_873_984)
    assert family.forward_flops(arch, 1) == 40 * (qkvo + attn + swiglu) + conv
    assert family.forward_flops(arch, 64) == pytest.approx(229.02e12, rel=1e-4)


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
    """The serving call records ``emct.swiglu`` once a block and
    ``emct.layer_scale`` twice; their readers give a finite, non-negative
    figure (device time: none on the CPU) and None on a trace without
    them."""
    spec = MICRO
    model = create_model(spec["port_config"], 10, device="cpu")
    infer = make_infer_fn(model, AugmentConfig(**spec["input"]), device="cpu")
    s = spec["input"]["resize_size"]
    images = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8)
    steps, depth = 2, spec["architecture"]["depth"]
    trace = devtrace.Trace(devtrace.profile(lambda i: infer(images), steps), steps)
    ctx = harness.TracedRun(trace, [], 0.0, 0, 0.0, "cpu")
    for span, per_block in (("swiglu", 1), ("layer_scale", 2)):
        assert len(program_spans.ranges(trace, span)) == steps * depth * per_block
        value = harness.load_file(BENCH / "layer_metrics" / f"{span}_ms.serve.py").read(ctx)
        assert value is not None and math.isfinite(value) and value >= 0.0
    swin = create_model(SWIN["port_config"], 10, device="cpu")
    other = make_infer_fn(swin, AugmentConfig(**SWIN["input"]), device="cpu")
    s = SWIN["input"]["resize_size"]
    small = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8)
    without = devtrace.Trace(devtrace.profile(lambda i: other(small), 1), 1)
    ctx = harness.TracedRun(without, [], 0.0, 0, 0.0, "cpu")
    assert harness.load_file(BENCH / "layer_metrics" / "layer_scale_ms.serve.py").read(
        ctx) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the tiny DINOv2 cell added as files."""
    root_dir, _ = tiny_root(tmp_path_factory.mktemp("dinov2"))
    bench = json.loads((root_dir / "BENCHMARK.json").read_text())
    path = f"h100_bench/configs/{MICRO['name']}.json"
    (root_dir / path).write_text(json.dumps(MICRO))
    bench["configs"].append({"name": MICRO["name"], "source": "https://example.org/tiny",
                             "file": path, "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": CELL, "config": MICRO["name"], "traffic": "serve-tiny",
                               "chips": 1, "why": "a CPU test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "serve-dinov2g-518-b64" in metric.get("workloads", []):
            metric["workloads"].append(CELL)
    (root_dir / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root_dir / "h100_bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps(TINY_LIMITS["serve"]))
    return root_dir


def test_tiny_dinov2_cell_is_correct(root):
    cell = harness.load_cell(root, CELL)
    assert "layer_scale_ms.serve" in {m["name"] for m in cell.per_layer}
    result, check = harness.run(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"], check
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(check) == {"logits_rel_l2"}
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_tiny_dinov2_cell_without_layer_scale_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(vit.LayerScale, "forward", lambda self, x, branch: x + branch)
    cell = harness.load_cell(root, CELL)
    result, check = harness.run(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], check
    assert check["logits_rel_l2"]["value"] > check["logits_rel_l2"]["limit"], check
