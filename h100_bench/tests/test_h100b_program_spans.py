"""The readers of the program's own spans (``program_spans.py`` and the
per-layer metrics on it) on a tiny train step and serving call profiled on
the CPU through ``devtrace.profile``: a finite, non-negative value where the
span ran, None where it did not."""

from __future__ import annotations

import math

import pytest
import torch

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_infer_fn
from ego_moment_cle_vit_tpu_torch import make_train_step
from ego_moment_cle_vit_tpu_torch.data.augment import AugmentConfig
from h100b_tiny import BENCH, SWIN, VIT

from h100_bench import devtrace, harness, program_spans

torch.set_num_threads(2)
TRAIN = ["augment_ms.train", "loss_ms.train", "backward_ms.train", "host_read_ms.train",
         "dispatch_idle_ms.train"]
SERVE = ["preprocess_ms.serve", "dispatch_idle_ms.serve"]
STEPS = 2


def _ctx(trace):
    return harness.TracedRun(trace, [], 0.0, 0, 0.0, "cpu")


def _images(spec, b=2):
    s = spec["input"]["resize_size"]
    return torch.randint(0, 256, (b, s, s, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(5))


def _train_trace(spec):
    model = create_model(spec["port_config"], 10, device="cpu")
    state = create_train_state(model, spec["port_config"], 100, device="cpu")
    step = make_train_step(model, AugmentConfig(**spec["input"]), device="cpu")
    images, labels = _images(spec), torch.tensor([1, 2])
    gen = torch.Generator().manual_seed(3)
    return devtrace.Trace(devtrace.profile(lambda i: step(state, images, labels, gen), STEPS),
                          STEPS)


def _serve_trace(spec):
    model = create_model(spec["port_config"], 10, device="cpu")
    infer = make_infer_fn(model, AugmentConfig(**spec["input"]), device="cpu")
    images = _images(spec)
    return devtrace.Trace(devtrace.profile(lambda i: infer(images), STEPS), STEPS)


@pytest.fixture(scope="module", params=[SWIN, VIT], ids=["swin", "vit"])
def traces(request):
    return {"train": _train_trace(request.param), "serve": _serve_trace(request.param)}


def _read(metric, trace):
    return harness.load_file(BENCH / "layer_metrics" / f"{metric}.py").read(_ctx(trace))


@pytest.mark.parametrize("kind, metrics, other", [("train", TRAIN, "serve"),
                                                  ("serve", SERVE, "train")])
def test_readers_where_the_span_ran_and_where_not(traces, kind, metrics, other):
    for metric in metrics:
        value = _read(metric, traces[kind])
        assert value is not None and math.isfinite(value) and value >= 0.0, (metric, value)
        assert _read(metric, traces[other]) is None, metric


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_dispatch_idle_within_the_stretch_idle(traces, kind):
    t = traces[kind]
    idle_ms = 1e3 * (t.window_s - t.busy_s)
    value = _read(f"dispatch_idle_ms.{kind}", t)
    assert 0.0 < value * t.steps <= idle_ms + 1e-9
    # on the CPU the device runs nothing: all of the step's span is idle, less
    # the host read
    whole = program_spans.host_s_in(t, f"{kind}.{'step' if kind == 'train' else 'infer'}")
    read = program_spans.host_s_in(t, "train.host_read") if kind == "train" else 0.0
    assert value * t.steps == pytest.approx(1e3 * (whole - read), rel=1e-9)


def test_one_range_a_step(traces):
    counts = {name: len(program_spans.ranges(traces["train"], name))
              for name in ("train.step", "train.augment", "train.forward", "train.loss",
                           "train.backward", "train.update", "train.host_read")}
    assert counts == dict.fromkeys(counts, STEPS)
    assert program_spans.ranges(traces["train"], "train.grad_sum") == []
    assert len(program_spans.ranges(traces["serve"], "serve.infer")) == STEPS


def test_a_program_without_spans_reads_none():
    """The parent of the spans records none: every reader returns None."""
    trace = devtrace.Trace(devtrace.profile(lambda i: torch.ones(8).sum(), STEPS), STEPS)
    for metric in TRAIN + SERVE:
        assert _read(metric, trace) is None, metric


def test_interval_arithmetic():
    a = [[0, 10], [20, 30]]
    b = [[5, 22], [25, 26], [40, 50]]
    assert program_spans._intersect(a, b) == [[5, 10], [20, 22], [25, 26]]
    assert program_spans._subtract(a, b) == [[0, 5], [22, 25], [26, 30]]
    assert program_spans._subtract(a, []) == a
    assert program_spans._subtract(a, [[-5, 100]]) == []
