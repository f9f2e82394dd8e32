"""The reference against the program's plain path at a small size (the CPU
runs every kernel's plain version; the program built in float32): the
served logits, one training step's augmentation, loss and every gradient,
and the optimizer's update."""

from __future__ import annotations

import json

import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state
from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug
from h100b_tiny import SWIN, VIT

from h100_bench import harness
from h100_bench.kinds.train import parts
from h100_bench.reference import augment as ref_aug
from h100_bench.reference.model import Dense, RefModel
from h100_bench.reference.optim import RefOptimizer
from h100_bench.weights import make_batches

torch.set_num_threads(2)
SEED = 11


def fp32(spec):
    """The configuration computed and held in float32 throughout."""
    spec = json.loads(json.dumps(spec))
    spec["port_config"]["model"]["bf16"] = False
    spec["port_config"]["model"]["moment"]["bf16_params"] = False
    return spec


def pair(spec):
    """The program and the reference on the same weights, in float32."""
    spec = fp32(spec)
    cell = harness.Cell(spec["name"], None, spec, {"batch": 4}, 1, {}, [], [])
    weights = harness.make_weights(cell, SEED, torch.device("cpu"))
    prog = create_model(spec["port_config"], spec["num_classes"], device="cpu")
    prog.load_state_dict(weights, strict=True)
    ref = RefModel(spec)
    ref.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True)
    return prog, ref, weights


def batch(spec, n=4):
    images, labels = make_batches(SEED, 1, n, spec["input"]["resize_size"],
                                  spec["num_classes"], "cpu")
    return images[0], labels[0]


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@pytest.mark.parametrize("spec", [SWIN, VIT], ids=["swin", "vit"])
def test_serving_logits(spec):
    prog, ref, _ = pair(spec)
    images, _ = batch(spec)
    anchor, _ = prog_aug.dual_view_eval_batch(images, prog_aug.AugmentConfig(**spec["input"]))
    ref_anchor, _ = ref_aug.dual_view_eval_batch(images, ref_aug.AugmentConfig(**spec["input"]))
    assert torch.equal(anchor, ref_anchor)
    with torch.no_grad():
        assert rel(prog.eval().inference(anchor), ref.infer(anchor)) < 1e-4


@pytest.mark.parametrize("spec", [SWIN, VIT], ids=["swin", "vit"])
def test_training_step(spec):
    prog, ref, weights = pair(spec)
    images, labels = batch(spec)
    views = [m.dual_view_train_batch(images, torch.Generator().manual_seed(5),
                                     m.AugmentConfig(**spec["input"]))
             for m in (prog_aug, ref_aug)]
    assert all(torch.equal(a, b) for a, b in zip(*views))
    anchor, positive = views[0]

    prog.train()
    loss = prog(anchor, positive, labels, generator=torch.Generator().manual_seed(6))["loss"]
    loss.backward()
    ref_loss = ref.loss_and_grads(anchor, positive, labels, torch.Generator().manual_seed(6))
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref_params = dict(ref.named_parameters())
    norms = {n: float(p.grad.norm()) for n, p in ref_params.items()}
    floor = 1e-3 * sorted(norms.values())[len(norms) // 2]
    for name, p in prog.named_parameters():
        g, want = p.grad, ref_params[name].grad
        assert g is not None and want is not None, name
        if norms[name] >= floor:  # leaves with a gradient to speak of
            assert rel(g, want) < 1e-3, name

    # one update on both from the same gradients
    state = create_train_state(prog, spec["port_config"], 1000, device="cpu")
    state.optimizer.step()
    dense = {f"{p}.weight" for p, m in ref.named_modules() if isinstance(m, Dense)}
    RefOptimizer(ref_params, dense, spec["port_config"]["training"], 1000).step()
    for name, p in prog.named_parameters():
        moved = parts(name, p.detach() - weights[name].float())
        want = parts(name, ref_params[name].detach() - weights[name].float())
        grads = parts(name, ref_params[name].grad)
        for (part, m), (_, w), (_, g) in zip(moved, want, grads):
            if float(g.norm()) >= floor:  # a part without gradient moves by round-off
                assert rel(m, w) < 1e-3, part
