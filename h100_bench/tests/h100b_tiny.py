"""Tiny cells for the CPU tests: a copy of the benchmark's folder and
``BENCHMARK.json`` in a temporary directory, with three small configurations
(the registered ``swin_micro`` and ``vit_micro`` backbones under the
flagship's heads, the multi-scale head for the ViT at 64 px, and the 'add'
head for the ViT at 144 px, whose N = 81 >= D = 64 takes the dense moment
route, and whose serving cell also compares the iSQRT's output) and small
traffic, added as files only: no code of the benchmark changes."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
SEED = 2 ** 31 + 12345

# limits of the tiny cells, from CPU readings of the program and the control
# (see test_h100b_faults.py): the program reads under them, the faults over
TINY_LIMITS = {
    "serve": {"logits_rel_l2": 0.05},
    "train": {"first_grad_norm_gap": 0.05, "change_norm_gap": 0.1},
}
# the dense route's iSQRT output, on the serving cell that takes it: the
# program's plain path reads 0 on the CPU, its bf16-iteration control ~0.004
TINY_ISQRT_LIMIT = {"isqrt_rel_l2": 0.002}


def tiny_limits(kind: str, spec: dict) -> dict:
    dense = kind == "serve" and spec is VIT_DENSE
    return {**TINY_LIMITS[kind], **(TINY_ISQRT_LIMIT if dense else {})}


def _tiny_spec(base: str, name: str, arch: dict, data: dict, kernels: dict) -> dict:
    spec = json.loads((BENCH / "configs" / base).read_text())
    spec["name"] = name
    spec["architecture"] = arch
    spec["input"] = data
    spec["reference_chunk"] = 3
    spec["kernels"] = kernels
    model = spec["port_config"]["model"]
    model["backbone_name"] = arch["backbone_name"]
    model["moment"].update(d_out=256, sketch_dim=512)
    spec["port_config"]["data"] = {"input_size": data["input_size"],
                                   "resize_size": data["resize_size"]}
    # the factored second moment at this size too: second_proj [128, *] alone
    spec["port_config"]["training"]["optimizer"]["factored_threshold"] = 200_000
    return spec


SWIN = _tiny_spec(
    "swinB-224-flagship.json", "swin-micro",
    {"family": "swin", "backbone_name": "swin_micro_patch4_window7_56", "img_size": 56,
     "patch_size": 4, "embed_dim": 128, "depths": [1, 1], "num_heads": [4, 8],
     "window_size": 7, "mlp_ratio": 4.0, "num_features": 256},
    {"resize_size": 64, "input_size": 56},
    {"serve": {"window_attention_fwd": 2, "gpf_fwd": 1},
     "train": {"window_attention_fwd": 2, "window_attention_bwd": 2, "gpf_fwd": 1,
               "gpf_bwd": 1}})
VIT = _tiny_spec(
    "vitL16-448-multiscale.json", "vit-micro",
    {"family": "vit", "backbone_name": "vit_micro_patch16_64", "img_size": 64, "patch_size": 16,
     "embed_dim": 64, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0, "num_features": 64},
    {"resize_size": 72, "input_size": 64},
    {"serve": {"gpf_fwd": 1}, "train": {"gpf_fwd": 1, "gpf_bwd": 1}})
VIT_DENSE = _tiny_spec(
    "vitB16-448-flagship.json", "vit-micro-dense",
    {"family": "vit", "backbone_name": "vit_micro_patch16_64", "img_size": 144, "patch_size": 16,
     "embed_dim": 64, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0, "num_features": 64},
    {"resize_size": 160, "input_size": 144},
    {"serve": {"gpf_fwd": 1, "newton_schulz_isqrt_fp32_fwd": 1},
     "train": {"gpf_fwd": 1, "gpf_bwd": 1, "newton_schulz_isqrt_fp32_fwd": 1}})
TRAFFIC = {
    "serve-tiny": {"kind": "serve", "batch": 3, "ring": 2, "warmup": 1, "profile_steps": 2},
    "train-tiny": {"kind": "train", "batch": 4, "ring": 3, "checked_steps": 3, "warmup": 0,
                   "profile_steps": 2},
}


def tiny_root(tmp: Path) -> tuple[Path, list]:
    """A checkout-like directory with the tiny cells added; returns it and
    the tiny cells' names."""
    shutil.copytree(BENCH, tmp / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = []
    for spec in (SWIN, VIT, VIT_DENSE):
        path = f"h100_bench/configs/{spec['name']}.json"
        (tmp / path).write_text(json.dumps(spec))
        bench["configs"].append({"name": spec["name"], "source": "https://example.org/tiny",
                                 "file": path, "reduced": [], "why": "a CPU test"})
        for traffic, params in TRAFFIC.items():
            (tmp / "h100_bench" / "traffic" / f"{traffic}.json").write_text(json.dumps(params))
            kind = params["kind"]
            name = f"{kind}-{spec['name']}"
            cells.append(name)
            bench["workloads"].append({"name": name, "config": spec["name"], "traffic": traffic,
                                       "chips": 1, "why": "a CPU test"})
            (tmp / "h100_bench" / "limits" / f"{name}.json").write_text(
                json.dumps(tiny_limits(kind, spec)))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            kinds = {w.split("-")[0] for w in metric["workloads"]}
            metric["workloads"] += [c for c in cells if c.split("-")[0] in kinds]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp, cells
