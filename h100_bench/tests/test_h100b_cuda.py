"""On the card, at each cell's own size: on three seeds the program reads
under every limit, and the control (the reference in float8 where the
configuration computes in bfloat16) and, for training, the half-batch fault
each read over one limit at least.

    python3 -m pytest -q -m cuda h100_bench/tests/test_h100b_cuda.py
"""

from __future__ import annotations

import json

import pytest
import torch

from h100b_tiny import ROOT

from h100_bench import calibrate, harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = harness.load_cell(ROOT, name)
    dev = torch.device("cuda", 0)
    harness.build_kernels(cell, dev)
    for seed in SEEDS:
        if cell.kind == "serve":
            out = calibrate.serve_readings(cell, seed, dev, control=True)
            planted = ("control",)
        else:
            out = calibrate.train_readings(cell, seed, dev, control=True, fault=True)
            planted = ("control", "half_batch")
        assert all(out[k] <= v for k, v in cell.limits.items()), (seed, out)
        for p in planted:
            assert any(out[f"{p}.{k}"] > v for k, v in cell.limits.items()), (seed, p, out)
