"""The benchmark's spans fire around the program's layers in ``inference``
and in the training forward, and around the optimizer's update."""

from __future__ import annotations

import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_infer_fn
from ego_moment_cle_vit_tpu_torch import make_train_step
from ego_moment_cle_vit_tpu_torch.data.augment import AugmentConfig
from h100b_tiny import SWIN, VIT

from h100_bench import devtrace

torch.set_num_threads(2)
HEADS = {"backbone", "gpf", "moment_head", "classifier"}


@pytest.mark.parametrize("spec", [SWIN, VIT], ids=["swin", "vit"])
def test_spans_in_inference(spec):
    model = create_model(spec["port_config"], 10, device="cpu")
    aug = AugmentConfig(**spec["input"])
    infer = make_infer_fn(model, aug, device="cpu")
    s = spec["input"]["resize_size"]
    images = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8)
    with devtrace.spans(model):
        trace = devtrace.Trace(devtrace.profile(lambda i: infer(images), 2), 2)
    assert {k: len(v) for k, v in trace.ranges.items() if k in HEADS} == dict.fromkeys(HEADS, 2)
    assert len(trace.ranges["step"]) == 2


@pytest.mark.parametrize("spec", [SWIN, VIT], ids=["swin", "vit"])
def test_spans_in_training(spec):
    model = create_model(spec["port_config"], 10, device="cpu")
    state = create_train_state(model, spec["port_config"], 100, device="cpu")
    step = make_train_step(model, AugmentConfig(**spec["input"]), device="cpu")
    s = spec["input"]["resize_size"]
    images = torch.randint(0, 256, (2, s, s, 3), dtype=torch.uint8)
    labels = torch.tensor([1, 2])
    gen = torch.Generator().manual_seed(3)
    with devtrace.spans(model, state.optimizer):
        trace = devtrace.Trace(devtrace.profile(lambda i: step(state, images, labels, gen), 2),
                               2)
    counts = {k: len(v) for k, v in trace.ranges.items()}
    assert all(counts[k] == 2 for k in HEADS | {"optimizer"}), counts
    assert "step" not in vars(state.optimizer)  # the wrapper is gone again
