"""The port's spans (``utils/trace.py``) on the CPU: where a train step, a
serving call, the evaluator's ablations and a background loader record them
under ``torch.profiler``, and that nothing is recorded, or entered, without
one.

Two tiny models, ``swin_micro`` and ``vit_micro`` (the latter with the
multi-scale classifier), at batch 2.  The kernel spans
(``emct.kernel.<wrapper>``) wrap CUDA launches only, so the CPU's plain
versions record none; ``tests/test_torch_cuda.py`` counts them on the card.
"""

import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_infer_fn
from ego_moment_cle_vit_tpu_torch import make_train_step
from ego_moment_cle_vit_tpu_torch.data import AugmentConfig, BatchLoader, SyntheticUFGDataset
from ego_moment_cle_vit_tpu_torch.utils import trace

torch.set_num_threads(1)

B = 2
LAYERS = ("emct.backbone", "emct.gpf", "emct.moment_head", "emct.classifier")
PHASES = ("emct.train.augment", "emct.train.forward", "emct.train.backward",
          "emct.train.update")


def _config(backbone, size, classifier):
    return {
        "model": {
            "backbone_name": backbone,
            "gpf": {"degree_p": 2, "degree_q": 2, "similarity": "dot"},
            "moment": {"d_out": 32, "sketch_dim": 128, "use_third_order": True,
                       "isqrt_iterations": 3},
            "classifier": {"fusion_type": "add", "dropout": 0.1, **classifier},
        },
        "data": {"input_size": size, "resize_size": size + 8},
        "training": {"optimizer": {"lr": 3e-4}, "scheduler": {"warmup_epochs": 0},
                     "loss": {"lambda_triplet": 0.6, "lambda_align": 0.1, "margin": 0.3},
                     "epochs": 1},
    }


CONFIGS = {
    "swin": _config("swin_micro_patch4_window7_56", 56, {}),
    "vit": _config("vit_micro_patch16_64", 64, {"type": "multiscale"}),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engine(request):
    cfg = CONFIGS[request.param]
    model = create_model(cfg, 5, device="cpu")
    aug = AugmentConfig(**cfg["data"])
    state = create_train_state(model, cfg, 10, device="cpu")
    s = cfg["data"]["resize_size"]
    images = torch.randint(0, 256, (B, s, s, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    return {"model": model, "aug": aug, "state": state, "images": images,
            "labels": torch.tensor([1, 3]),
            "step": make_train_step(model, aug, device="cpu"),
            "infer": make_infer_fn(model, aug, device="cpu")}


def _spans(fn):
    """Run ``fn`` under a CPU profiler: ``{name: [(start, end), ...]}`` of
    the ``emct.*`` ranges it recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.events():
        if e.name.startswith(trace.PREFIX):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_train_step_spans(engine):
    e = engine
    gen = torch.Generator().manual_seed(4)
    spans = _spans(lambda: e["step"](e["state"], e["images"], e["labels"], gen))
    assert {k: len(v) for k, v in spans.items()} == dict.fromkeys(
        ("emct.train.step", "emct.train.loss", "emct.train.host_read") + PHASES + LAYERS, 1)
    (step,) = spans["emct.train.step"]
    phases = [spans[p][0] for p in PHASES]
    assert all(_inside(p, step) for p in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))  # in order, apart
    assert _inside(spans["emct.train.host_read"][0], spans["emct.train.update"][0])
    forward = spans["emct.train.forward"][0]
    assert all(_inside(spans[k][0], forward) for k in LAYERS + ("emct.train.loss",))


def test_infer_spans(engine):
    spans = _spans(lambda: engine["infer"](engine["images"]))
    assert {k: len(v) for k, v in spans.items()} == dict.fromkeys(
        ("emct.serve.infer", "emct.serve.preprocess") + LAYERS, 1)
    call = spans["emct.serve.infer"][0]
    assert all(_inside(v[0], call) for v in spans.values())
    assert spans["emct.serve.preprocess"][0][1] <= spans["emct.backbone"][0][0]


@pytest.mark.parametrize("mode, layers", [
    ("full", LAYERS), ("no_gpf", ("emct.backbone", "emct.moment_head", "emct.classifier")),
    ("uniform_graph", ("emct.backbone", "emct.moment_head", "emct.classifier")),
    ("cls_only", ("emct.backbone",))])
def test_ablation_spans(engine, mode, layers):
    model = engine["model"]
    anchor = torch.zeros(B, *([engine["aug"].input_size] * 2), 3)
    model.eval()
    with torch.inference_mode():
        spans = _spans(lambda: model.ablation_forward(anchor, anchor, mode))
    assert {k: len(v) for k, v in spans.items()} == dict.fromkeys(layers, 1)


def test_no_profiler_enters_no_range(engine, monkeypatch):
    """Without a profiler the spans cost one flag check: ``record_function``
    is never called (here it raises if it is)."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    e = engine
    loss = e["step"](e["state"], e["images"], e["labels"], torch.Generator().manual_seed(6))
    assert torch.isfinite(loss)
    assert torch.isfinite(e["infer"](e["images"])).all()
    with trace.span("train.step") as inside:
        assert inside is None


def test_span_name_under_a_profiler():
    def probe():
        with trace.span("probe"):
            torch.ones(2).sum()

    spans = _spans(probe)
    assert list(spans) == ["emct.probe"] and len(spans["emct.probe"]) == 1


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_loader_waits(prefetch):
    """A background loader records one ``emct.data.wait`` per batch handed
    over, and one more for the wait on the end of the epoch; a loader with no
    background thread records none."""
    loader = BatchLoader(SyntheticUFGDataset(num_classes=3, samples_per_class=4, image_size=8),
                         batch_size=4, shuffle=False, num_workers=1, prefetch=prefetch)
    batches = []
    spans = _spans(lambda: batches.extend(loader))
    assert len(batches) == len(loader) == 3
    assert len(spans.get("emct.data.wait", [])) == (len(batches) + 1 if prefetch else 0)
    assert set(spans) <= {"emct.data.wait"}
