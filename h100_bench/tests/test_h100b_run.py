"""A whole run of each tiny cell on the CPU: set-up, window, comparison and
the result line, with the look for a card skipped."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest
import torch

from h100b_tiny import ROOT, SEED, tiny_root

from h100_bench import harness

torch.set_num_threads(2)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run_cell(root_dir, name, trace=False, seconds=0.5):
    cell = harness.load_cell(root_dir, name)
    return harness.run(cell, SEED, seconds, trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", ["serve-swin-micro", "train-swin-micro", "serve-vit-micro",
                                  "train-vit-micro", "serve-vit-micro-dense",
                                  "train-vit-micro-dense"])
def test_sound_run_is_correct(root, name):
    root_dir, _ = root
    result, check = run_cell(root_dir, name)
    assert result["correct"], check
    assert result["failed"] == 0 and result["attempted"] > 0
    cell = harness.load_cell(root_dir, name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(check) == set(cell.limits)


@pytest.mark.parametrize("name", ["serve-swin-micro", "train-vit-micro"])
def test_traced_run_reports_a_breakdown(root, name):
    result, _ = run_cell(root[0], name, trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_last_line_keys(root):
    result, check = run_cell(root[0], "serve-vit-micro")
    out = io.StringIO()
    with redirect_stdout(out):
        harness.emit(result, check)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["device"]["platform"] == "cpu"
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_a_configuration_added_as_files_runs(root):
    """The copy holds the tiny cells as data files only; its own harness, not
    this checkout's, runs one and prints the result line (the program comes
    from this checkout)."""
    root_dir, _ = root
    code = (f"import sys, time, torch; sys.path[:0] = [{str(root_dir)!r}, {str(ROOT)!r}]; "
            "from h100_bench import harness; "
            f"assert harness.__file__.startswith({str(root_dir)!r}); "
            f"cell = harness.load_cell(harness.Path({str(root_dir)!r}), 'train-swin-micro'); "
            f"r, c = harness.run(cell, {SEED}, 0.3, False, torch.device('cpu'), "
            "time.perf_counter()); harness.emit(r, c)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root_dir)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"]
    assert out.stderr.strip().splitlines()[-1].startswith("compared change_norm_gap")


# A backbone family added as files: the ViT's net under a family name of its
# own, with the CLS token as the global feature ("cls") or, wrongly for this
# program, the mean of the tokens ("mean").
FAMILY = '''"""ViT as a family of its own file."""
from h100_bench.reference.families.vit import ViT as Net

MODULE = "vit"


def features(tokens):
    return tokens[:, 1:], {glob}
'''
GLOBAL = {"cls": "tokens[:, 0]", "mean": "tokens.mean(dim=1)"}


@pytest.mark.parametrize("feature,correct", [("cls", True), ("mean", False)])
def test_a_family_added_as_files_runs(tmp_path, feature, correct):
    """A copy of the benchmark gains a family (``reference/families/`` and
    ``flops/``) and a configuration of it as files only; its own harness
    runs a traced tiny cell (the FLOP model and the kernels' work read the
    family's ``flops`` file) with that family's reference, which decides
    ``correct``."""
    root_dir, _ = tiny_root(tmp_path)
    family = f"vit_{feature}"
    bench = root_dir / "h100_bench"
    (bench / "reference" / "families" / f"{family}.py").write_text(
        FAMILY.format(glob=GLOBAL[feature]))
    (bench / "flops" / f"{family}.py").write_text(
        "from h100_bench.flops.vit import forward_flops, tokens  # noqa: F401\n")
    spec_path = bench / "configs" / "vit-micro-dense.json"
    spec = json.loads(spec_path.read_text())
    spec["architecture"]["family"] = family
    spec_path.write_text(json.dumps(spec))
    code = (f"import sys, time, torch; sys.path[:0] = [{str(root_dir)!r}, {str(ROOT)!r}]; "
            "from h100_bench import harness; "
            f"cell = harness.load_cell(harness.Path({str(root_dir)!r}), "
            "'serve-vit-micro-dense'); "
            f"r, c = harness.run(cell, {SEED}, 0.3, True, torch.device('cpu'), "
            "time.perf_counter()); harness.emit(r, c); "
            "print(sorted(m for m in sys.modules if m.startswith('h100_bench.reference.fam')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root_dir)
    assert out.returncode == 0, out.stderr[-3000:]
    *_, line, loaded = out.stdout.strip().splitlines()
    assert json.loads(line)["correct"] is correct
    assert set(eval(loaded)) == {"h100_bench.reference.families",
                                 f"h100_bench.reference.families.{family}",
                                 "h100_bench.reference.families.vit"}


def test_without_a_card_no_result():
    """run.py looks for a card: without one it exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          "serve-swinB-224-b64", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
