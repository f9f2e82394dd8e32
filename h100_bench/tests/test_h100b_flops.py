"""The FLOP model against ``torch.utils.flop_counter.FlopCounterMode`` on the
program's plain path (the CPU runs every kernel's plain version), at batch 1,
for every configuration of the benchmark and the tiny ones (the dense moment
route in ``vitB16-448-flagship`` and ``vit-micro-dense``)."""

from __future__ import annotations

import importlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ego_moment_cle_vit_tpu_torch import create_model
from h100b_tiny import BENCH, SWIN, VIT, VIT_DENSE

from h100_bench.flops.heads import heads_flops

torch.set_num_threads(4)
SPECS = {p.stem: json.loads(p.read_text()) for p in (BENCH / "configs").glob("*.json")}
SPECS.update({"swin-micro": SWIN, "vit-micro": VIT, "vit-micro-dense": VIT_DENSE})


def counted(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode, torch.no_grad():
        fn()
    return mode.get_total_flops()


@pytest.fixture(scope="module", params=sorted(SPECS))
def model_and_spec(request):
    spec = SPECS[request.param]
    model = create_model(spec["port_config"], spec["num_classes"], device="cpu",
                         dtype=torch.float32)
    yield model, spec
    del model


def test_serving_forward(model_and_spec):
    model, spec = model_and_spec
    arch = spec["architecture"]
    family = importlib.import_module(f"h100_bench.flops.{arch['family']}")
    n, d, s = family.tokens(arch), arch["num_features"], arch["img_size"]
    images = torch.randn(1, s, s, 3)
    model.eval()
    got = counted(lambda: model.inference(images))
    # the plain GPF forms both Grams even when both views are one tensor; the
    # model counts the one Gram serving needs
    want = family.forward_flops(arch, 1) + heads_flops(spec, 1, n, training=False) + 2 * n * n * d
    assert got == pytest.approx(want, rel=1e-9)


def test_training_forward(model_and_spec):
    model, spec = model_and_spec
    arch = spec["architecture"]
    family = importlib.import_module(f"h100_bench.flops.{arch['family']}")
    n, s = family.tokens(arch), arch["img_size"]
    views = torch.randn(2, 1, s, s, 3)
    model.train()
    got = counted(lambda: model(views[0], views[1], torch.tensor([1]),
                                generator=torch.Generator().manual_seed(0)))
    want = family.forward_flops(arch, 2) + heads_flops(spec, 1, n, training=True)
    assert got == pytest.approx(want, rel=1e-9)
