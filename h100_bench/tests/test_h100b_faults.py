"""The timed path broken underneath a whole run: ``correct`` must come out
false for each fault a cell can have (one chip: no exchange between chips
to leave out), the dense route's iSQRT one step short or iterated in
bfloat16 among them, and the control must read over a limit."""

from __future__ import annotations

import time

import pytest
import torch

import ego_moment_cle_vit_tpu_torch as port
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz
from h100b_tiny import SEED, tiny_root

from h100_bench import calibrate, harness, isqrt_check
from h100_bench.reference.model import newton_schulz as ref_newton_schulz

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))[0]


def state_unchanged(make):
    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(state, images, labels, generator):
            state.optimizer.step = lambda *a, **k: True
            try:
                return step(state, images, labels, generator)
            finally:
                del state.optimizer.step
        return broken
    return wrapped


def half_batch(make):
    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda state, images, labels, g: step(state, images[: len(images) // 2],
                                                     labels[: len(labels) // 2], g)
    return wrapped


def logits_altered(make):
    def wrapped(*args, **kwargs):
        infer = make(*args, **kwargs)

        def broken(images):
            out = infer(images).clone()
            out[0] = out[0] + out.abs().max()
            return out
        return broken
    return wrapped


FAULTS = [("train", "make_train_step", state_unchanged),
          ("train", "make_train_step", half_batch),
          ("serve", "make_infer_fn", logits_altered)]


@pytest.mark.parametrize("model", ["swin-micro", "vit-micro", "vit-micro-dense"])
@pytest.mark.parametrize("kind,entry,fault", FAULTS, ids=[f[2].__name__ for f in FAULTS])
def test_fault_is_not_correct(root, monkeypatch, model, kind, entry, fault):
    monkeypatch.setattr(port, entry, fault(getattr(port, entry)))
    cell = harness.load_cell(root, f"{kind}-{model}")
    result, check = harness.run(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], check


def one_step_short(whole):
    return lambda m, k, eps: whole(m, k - 1, eps)


def bf16_iteration(whole):
    """The iteration with its iterates stored in bfloat16 (float32 sums)."""
    return lambda m, k, eps: ref_newton_schulz(m.float(), k, eps, "bf16").to(m.dtype)


@pytest.mark.parametrize("kind,fault", [("serve", one_step_short), ("train", one_step_short),
                                        ("serve", bf16_iteration)],
                         ids=["serve-short", "train-short", "serve-bf16"])
def test_dense_isqrt_fault_is_not_correct(root, monkeypatch, kind, fault):
    """The program's Newton–Schulz iSQRT of the dense route one step short,
    or iterated in bfloat16: in serving the iSQRT's own output fails its
    limit."""
    whole = newton_schulz.newton_schulz_isqrt_kernel
    monkeypatch.setattr(newton_schulz, "newton_schulz_isqrt_kernel", fault(whole))
    cell = harness.load_cell(root, f"{kind}-vit-micro-dense")
    result, check = harness.run(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not result["correct"], check
    if kind == "serve":
        assert check[isqrt_check.NAME]["value"] > check[isqrt_check.NAME]["limit"], check


@pytest.mark.parametrize("name", ["serve-swin-micro", "serve-vit-micro", "train-vit-micro",
                                  "serve-vit-micro-dense", "train-vit-micro-dense"])
def test_control_reads_over_a_limit(root, name):
    """The reference in float8 in the program's place fails a number the
    program passes (at this size the Swin step's float8 error stays under
    the tiny limits; the cell's own test on the card holds it)."""
    cell = harness.load_cell(root, name)
    dev = torch.device("cpu")
    if cell.kind == "serve":
        out = calibrate.serve_readings(cell, SEED, dev, control=True)
    else:
        out = calibrate.train_readings(cell, SEED, dev, control=True, fault=False)
    assert all(out[k] <= v for k, v in cell.limits.items())
    assert any(out[f"control.{k}"] > v for k, v in cell.limits.items())
