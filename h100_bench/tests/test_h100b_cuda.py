"""On the card, at each cell's own size: on three seeds the program reads
under every limit, and the control (the reference in float8 where the
configuration computes in bfloat16; for ``isqrt_rel_l2`` the iteration in
bfloat16 in the kernel's place) and the planted faults (training: half of
the batch; the dense route's serving: the iSQRT one step short) each read
over one limit at least.  Where a cell compares the iSQRT's output, a whole
run with the iSQRT one step short or iterated in bfloat16 is not correct.

    python3 -m pytest -q -m cuda h100_bench/tests/test_h100b_cuda.py
"""

from __future__ import annotations

import importlib
import json
import math
import time

import pytest
import torch

from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz
from h100b_tiny import ROOT

from h100_bench import calibrate, harness, isqrt_check
from h100_bench.reference.model import newton_schulz as ref_newton_schulz

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
ISQRT_CELLS = [c for c in CELLS if isqrt_check.NAME in json.loads(
    (ROOT / "h100_bench" / "limits" / f"{c}.json").read_text())]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_the_cells_size(name):
    dev = card()
    cell = harness.load_cell(ROOT, name)
    harness.build_kernels(cell, dev)
    for seed in SEEDS:
        if cell.kind == "serve":
            fault = isqrt_check.wanted(cell)
            out = calibrate.serve_readings(cell, seed, dev, control=True, fault=fault)
            planted = ("control", "fewer_steps") if fault else ("control",)
        else:
            out = calibrate.train_readings(cell, seed, dev, control=True, fault=True)
            planted = ("control", "half_batch")
        assert all(out[k] <= v for k, v in cell.limits.items()), (seed, out)
        for p in planted:
            assert any(out.get(f"{p}.{k}", -math.inf) > v for k, v in cell.limits.items()), \
                (seed, p, out)


def dense_wrapper(cell):
    """The cell's Newton–Schulz kernel wrapper (its launch counter)."""
    (wrapper,) = [w for w in cell.spec["kernels"]["serve"] if w.startswith("newton_schulz")]
    module, fn = harness.kernel_module(wrapper).WRAPPER.split(":")
    return getattr(importlib.import_module(module), fn)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ISQRT_CELLS)
@pytest.mark.parametrize("fault", ["one_step_short", "bf16_iteration"])
def test_dense_isqrt_fault_fails_a_whole_run(monkeypatch, name, fault):
    dev = card()
    cell = harness.load_cell(ROOT, name)
    harness.build_kernels(cell, dev)
    whole, counter = newton_schulz.newton_schulz_isqrt_kernel, dense_wrapper(cell)

    def broken(m, k, eps):
        if fault == "one_step_short":
            return whole(m, k - 1, eps)
        counter.launches += 1  # in the kernel's place, launch for launch
        return ref_newton_schulz(m.float(), k, eps, "bf16").to(m.dtype)
    monkeypatch.setattr(newton_schulz, "newton_schulz_isqrt_kernel", broken)
    result, check = harness.run(cell, SEEDS[0], 8.0, False, dev, time.perf_counter())
    assert not result["correct"], check
    assert check[isqrt_check.NAME]["value"] > check[isqrt_check.NAME]["limit"], check
