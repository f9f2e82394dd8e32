"""The reference against the program's plain path at a small size (the CPU
runs every kernel's plain version; the program built in float32): the
served logits, one training step's augmentation, loss and every gradient,
and the optimizer's update, on the token-subspace route (N < D) and on the
dense route (N >= D).  The dense iteration against float64 witnesses, and
the Swin and ViT families against their logits from before they moved to
``reference/families/``."""

from __future__ import annotations

import json

import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state
from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug
from h100b_tiny import SWIN, VIT, VIT_DENSE

from h100_bench import harness
from h100_bench.kinds.train import parts
from h100_bench.reference import augment as ref_aug
from h100_bench.reference.layers import Dense
from h100_bench.reference.model import RefModel, isqrt_dense, isqrt_subspace
from h100_bench.reference.optim import RefOptimizer
from h100_bench.weights import make_batches

torch.set_num_threads(2)
SEED = 11
SPECS = [SWIN, VIT, VIT_DENSE]
IDS = ["swin", "vit", "vit-dense"]


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


def test_the_dense_cell_takes_the_dense_route():
    arch = VIT_DENSE["architecture"]
    assert (arch["img_size"] // arch["patch_size"]) ** 2 >= arch["num_features"]


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_serving_logits(spec):
    prog, ref, _ = pair(spec)
    images, _ = batch(spec)
    anchor, _ = prog_aug.dual_view_eval_batch(images, prog_aug.AugmentConfig(**spec["input"]))
    ref_anchor, _ = ref_aug.dual_view_eval_batch(images, ref_aug.AugmentConfig(**spec["input"]))
    assert torch.equal(anchor, ref_anchor)
    with torch.no_grad():
        assert rel(prog.eval().inference(anchor), ref.infer(anchor)) < 1e-4


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
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


def spd_factors(n, d, seed):
    """A = centred tokens and B = W A with W a symmetric graph of positive
    weights, as the head forms them, in float64."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(2, n, d, generator=g, dtype=torch.float64)
    a = a - a.mean(dim=1, keepdim=True)
    r = torch.rand(2, n, n, generator=g, dtype=torch.float64)
    w = 0.5 * (r + r.transpose(-1, -2)) + n * torch.eye(n, dtype=torch.float64)
    return a, torch.matmul(w / n, a)


@pytest.mark.parametrize("n,d", [(81, 64), (64, 64), (40, 64)])
def test_dense_iteration_equals_the_subspace_one_in_float64(n, d):
    """Both routes compute one polynomial in M = A^T B; the subspace one, held
    to the program above, witnesses the dense one at any N and D."""
    a, b = spd_factors(n, d, 3)
    for k in (1, 3, 5):
        dense, sub = isqrt_dense(a, b, k, 1e-5), isqrt_subspace(a, b, k, 1e-5)
        assert float((dense - sub).norm() / sub.norm()) < 1e-12, k


def test_dense_iteration_converges_to_the_inverse_square_root():
    """Run long on a well-conditioned M, the iteration gives M^-1/2 by an
    eigendecomposition in float64."""
    a, b = spd_factors(400, 64, 4)
    m = torch.matmul(a.transpose(-1, -2), b)
    m = 0.5 * (m + m.transpose(-1, -2))
    vals, vecs = torch.linalg.eigh(m)
    assert float(vals.min() / vals.max()) > 0.05
    want = vecs @ torch.diag_embed(vals.rsqrt()) @ vecs.transpose(-1, -2)
    got = isqrt_dense(a, b, 30, 0.0)
    assert float((got - want).norm() / want.norm()) < 1e-10


def test_dense_iteration_in_float32_near_its_float64_self():
    """At the benchmark's k = 5 the float32 reference is its float64 self to
    float32 rounding; one step fewer is not."""
    a, b = spd_factors(81, 64, 5)
    want = isqrt_dense(a, b, 5, 1e-5)
    got = isqrt_dense(a.float(), b.float(), 5, 1e-5).double()
    assert float((got - want).norm() / want.norm()) < 1e-5
    short = isqrt_dense(a, b, 4, 1e-5)
    assert float((short - want).norm() / want.norm()) > 1e-2


# The reference's logits before the families moved to files of their own
# (the parent's ``reference/model.py``), SEED's weights and a batch of 2:
# ||logits||, logits[0, :4], logits[1, -2:], float32 and float8 control.
BEFORE = {
    ("swin-micro", "fp32"): (7.222421169281006, [0.17995904386043549, 1.006024956703186,
                                                 0.5479471683502197, 0.18627186119556427],
                             [0.9402661323547363, 0.9723107814788818]),
    ("swin-micro", "fp8"): (7.165351867675781, [0.11562108993530273, 1.0517529249191284,
                                                0.6114499568939209, 0.2030317485332489],
                            [0.8858608603477478, 1.001283884048462]),
    ("vit-micro", "fp32"): (4.165637493133545, [-0.3334355056285858, -0.24882322549819946,
                                                0.3987094461917877, 0.40527108311653137],
                            [0.250914067029953, 0.41816243529319763]),
    ("vit-micro", "fp8"): (4.119946479797363, [-0.2685526907444, -0.2388446182012558,
                                               0.30996695160865784, 0.40479061007499695],
                           [0.2599574327468872, 0.4038349688053131]),
}


@pytest.mark.parametrize("spec", [SWIN, VIT], ids=["swin", "vit"])
@pytest.mark.parametrize("precision", ["fp32", "fp8"])
def test_families_give_the_logits_they_gave_before_the_move(spec, precision):
    cell = harness.Cell(spec["name"], None, spec, {"batch": 2}, 1, {}, [], [])
    weights = harness.make_weights(cell, SEED, torch.device("cpu"))
    ref = RefModel(spec, precision)
    ref.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True)
    images, _ = make_batches(SEED, 1, 2, spec["input"]["resize_size"], spec["num_classes"], "cpu")
    anchor, _ = ref_aug.dual_view_eval_batch(images[0], ref_aug.AugmentConfig(**spec["input"]))
    out = ref.infer(anchor)
    norm, first, last = BEFORE[spec["name"], precision]
    assert float(out.norm()) == pytest.approx(norm, rel=1e-5)
    assert out[0, :4].tolist() == pytest.approx(first, rel=1e-5, abs=1e-6)
    assert out[1, -2:].tolist() == pytest.approx(last, rel=1e-5, abs=1e-6)
