"""``isqrt_rel_l2`` on the CPU: the sample drawn from the seed, the capture of
the moment head's inputs and iSQRT output (the sampled images, no other
call touched, the head as it was afterwards), and the reference from those
inputs against the program's plain dense route."""

from __future__ import annotations

import json

import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model
from ego_moment_cle_vit_tpu_torch.models.moment_head import MomentHead
from h100b_tiny import SEED, VIT_DENSE

from h100_bench import harness, isqrt_check
from h100_bench.reference.model import isqrt_dense, newton_schulz

torch.set_num_threads(2)


def test_draw_is_the_seeds():
    a = isqrt_check.draw(SEED, 8, 64, 64, 4)
    assert a == isqrt_check.draw(SEED, 8, 64, 64, 4)
    assert a != isqrt_check.draw(SEED + 1, 8, 64, 64, 4)
    assert len(a) == 8 and all(0 <= c < 64 for c in a)
    assert all(len(set(i)) == 4 and all(0 <= j < 64 for j in i) for i in a.values())
    assert isqrt_check.draw(SEED, 4, 4, 3, 8) == {c: [0, 1, 2] for c in range(4)}


def program(bf16: bool):
    spec = json.loads(json.dumps(VIT_DENSE))
    spec["port_config"]["model"]["bf16"] = bf16
    spec["port_config"]["model"]["moment"]["bf16_params"] = bf16
    cell = harness.Cell(spec["name"], None, spec, {"batch": 3}, 1, {}, [], [])
    model = create_model(spec["port_config"], spec["num_classes"], device="cpu")
    model.load_state_dict(harness.make_weights(cell, SEED, torch.device("cpu")), strict=True)
    s = spec["architecture"]["img_size"]
    images = torch.randn(3, s, s, 3, generator=torch.Generator().manual_seed(1))
    return cell, model.eval(), images


def captured(model, images, sample):
    capture = isqrt_check.Capture(model, sample)
    with torch.no_grad():
        capture.probe(lambda: model.inference(images))
        for call in range(max(sample) + 1):
            capture.arm(call)
            model.inference(images)
    capture.close()
    return capture.captured()


def test_capture_takes_the_sampled_images_and_restores_the_head():
    _, model, images = program(bf16=True)
    everything = captured(model, images, {0: [0, 1, 2]})
    some = captured(model, images, {1: [2, 0], 3: [1]})
    assert len(everything) == 1 and len(some) == 2
    for part in range(3):
        assert torch.equal(some[0][part], everything[0][part][[2, 0]])
        assert torch.equal(some[1][part], everything[0][part][[1]])
    assert "_isqrt" not in vars(model.moment_head)
    assert model.moment_head._isqrt.__func__ is MomentHead._isqrt
    assert not model.moment_head._forward_pre_hooks


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_reference_from_the_heads_inputs_is_the_programs(bf16):
    """The program's plain dense route (the CPU runs no kernel) and the
    reference from the captured inputs, rounding what the head keeps in the
    model's dtype: equal to float32 rounding; the bf16-iteration and TF32
    controls and one step fewer read over the serving limit."""
    cell, model, images = program(bf16)
    (tokens, graph, y), = captured(model, images, {0: [0, 1, 2]})
    assert y.dtype == (torch.bfloat16 if bf16 else torch.float32)
    ref = isqrt_check.reference(cell, tokens, graph, torch.device("cpu"))
    assert isqrt_check.rel_l2(y, ref) < 1e-6
    limit = 0.002
    control = isqrt_check.reference(cell, tokens, graph, torch.device("cpu"), "bf16")
    short = isqrt_check.reference(cell, tokens, graph, torch.device("cpu"), iterations=4)
    assert isqrt_check.rel_l2(control, ref) > limit
    assert isqrt_check.rel_l2(short, ref) > 100 * limit


def test_newton_schulz_controls():
    """fp32 is ``isqrt_dense``'s iteration bit for bit; the controls move it
    by their rounding, the bf16 one more than the TF32 one."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(2, 81, 64, generator=g)
    b = a + 0.1 * torch.randn(2, 81, 64, generator=g)
    exact = newton_schulz(a.transpose(-1, -2) @ b, 5, 1e-5)
    assert torch.equal(exact, isqrt_dense(a, b, 5, 1e-5))
    m = a.transpose(-1, -2) @ b
    gap = {p: float((newton_schulz(m, 5, 1e-5, p) - exact).norm() / exact.norm())
           for p in ("bf16", "tf32")}
    assert 1e-6 < gap["tf32"] < gap["bf16"] < 0.05
