"""The committed golden fixture, replayed in the PyTorch port.

``tests/golden/full_model_golden.npz`` freezes a ``vit_micro_patch16_64``
model (2 ViT blocks, cosine GPF 2x2, moment head with the FFT third-order
sketch, concat classifier with a hidden layer), its inputs, and what the JAX
package computed from them.  The port's model is built from the same config on
the CPU, takes the flax parameters and the sketch matrices through
``torch_state_dict_from_flax``, and must reproduce the logits, every loss term
and the single-view inference logits.  Tolerance: atol 1e-3, rtol 1e-4, what
``tests/test_golden_model.py`` allows the JAX package itself across XLA
versions (fp32 sum order through 2 blocks, 3 Newton-Schulz steps and the FFT
sketch); measured agreement is ~1e-6.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model
from ego_moment_cle_vit_tpu_torch.utils.convert import torch_state_dict_from_flax

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden" / "full_model_golden.npz"
ATOL, RTOL = 1e-3, 1e-4
LOSS_TERMS = ["loss_main_ce", "loss_anchor_ce", "loss_positive_ce", "loss_triplet", "loss_align"]


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def model(golden):
    spec = importlib.util.spec_from_file_location("_golden_gen", GOLDEN.parent / "make_golden.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    variables: dict = {}
    for key, arr in golden.items():
        if key.startswith("var::"):
            _, coll, path = key.split("::", 2)
            node = variables.setdefault(coll, {})
            *parents, leaf = path.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr
    assert sorted(variables) == ["constants", "params"]
    m = create_model(gen.CONFIG, gen.NUM_CLASSES, device="cpu")
    m.load_state_dict(torch_state_dict_from_flax(variables, m, device="cpu"))
    return m


@pytest.fixture(scope="module")
def outputs(golden, model):
    anchor, positive = (torch.from_numpy(golden[f"in::{k}"]) for k in ("anchor", "positive"))
    labels = torch.from_numpy(golden["in::labels"])
    with torch.no_grad():
        return model(anchor, positive, labels), model.inference(anchor)


@pytest.mark.parametrize("key", ["logits", "logits_anchor", "logits_positive"])
def test_golden_logits(golden, outputs, key):
    out, _ = outputs
    assert out[key].shape == golden[f"out::{key}"].shape == (4, 5)
    np.testing.assert_allclose(out[key].numpy(), golden[f"out::{key}"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("term", LOSS_TERMS)
def test_golden_loss_terms(golden, outputs, term):
    out, _ = outputs
    assert list(out["loss_dict"]) == LOSS_TERMS
    np.testing.assert_allclose(out["loss_dict"][term].item(), golden[f"loss::{term}"], atol=ATOL,
                               rtol=RTOL)


def test_golden_total_loss_and_inference(golden, outputs):
    out, infer_logits = outputs
    assert sorted(k[6:] for k in golden if k.startswith("loss::")) == sorted(LOSS_TERMS)
    np.testing.assert_allclose(out["loss"].item(), golden["out::loss"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(infer_logits.numpy(), golden["out::infer_logits"], atol=ATOL,
                               rtol=RTOL)
    # the comparison has power: the positive view's logits are not the anchor's
    assert np.abs(golden["out::logits_anchor"] - golden["out::logits_positive"]).max() > 10 * ATOL


def test_golden_every_leaf_is_carried_across(golden, model):
    n_flax = sum(k.startswith("var::") for k in golden)
    assert n_flax == len(model.state_dict()) == 52
    stray = {"params": {"backbone": {"backbone": {"vit": {"extra": np.zeros(3, np.float32)}}}}}
    with pytest.raises(KeyError, match="extra"):
        torch_state_dict_from_flax(stray, model, device="cpu")
