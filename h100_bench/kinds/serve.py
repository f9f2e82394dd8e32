"""Serving: a closed loop of one caller through ``make_infer_fn``'s ``infer``.

Each call takes the next uint8 batch of a ring of distinct seeded batches in
pinned host memory and ends when its logits are on the host, as a serving
caller reads them.  The window runs until ``--seconds`` have passed and ends
with the last call.  Afterwards every call's logits are compared with the
reference's logits of its batch, and, where the cell's limits name it, the
moment head's iSQRT output of a sample of calls with the reference's
(``isqrt_check.py``).

Traffic parameters: ``batch``, ``ring`` (distinct batches), ``warmup``
(calls before the window), ``profile_steps`` (calls in the traced stretch).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from h100_bench import devtrace, harness, isqrt_check
from h100_bench.weights import make_batches


def p95(values) -> float:
    """The 95th percentile, linear between the closest ranks (Python's
    ``statistics.quantiles`` inclusive method)."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def reference_logits(cell, weights, batches, device, precision="fp32") -> list:
    """The reference's logits of each batch, eval preprocessing included."""
    from h100_bench.reference import augment as ref_aug
    from h100_bench.reference.layers import fp32_products
    ref = harness.loaded_reference(cell, weights, precision, device)
    aug = harness.augment_config(cell, ref_aug)
    out = []
    with fp32_products():
        for images in batches:
            anchor, _ = ref_aug.dual_view_eval_batch(images.to(device), aug)
            out.append(ref.infer(anchor).float().cpu())
    del ref
    harness.free_device(device)
    return out


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out - ref).norm() / ref.norm())


def run(r: harness.Run):
    from ego_moment_cle_vit_tpu_torch import make_infer_fn
    from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug

    cell, dev, tr = r.cell, r.device, r.cell.traffic
    harness.build_kernels(cell, dev)
    weights = harness.make_weights(cell, r.seed, dev)
    model = harness.program_model(cell, weights, dev)
    del weights  # made again from the seed for the reference: not resident in the window
    harness.free_device(dev)
    infer = make_infer_fn(model, harness.augment_config(cell, prog_aug), device=dev)
    size = cell.spec["input"]["resize_size"]
    batches, _ = make_batches(r.seed, tr["ring"], tr["batch"], size, cell.spec["num_classes"], dev)
    host = [b.cpu().pin_memory() if dev.type == "cuda" else b.clone() for b in batches]
    launches = harness.Launches(cell)
    harness.log(harness.card_line(dev))

    capture = None
    if isqrt_check.wanted(cell):
        capture = isqrt_check.Capture(model, isqrt_check.draw(
            r.seed, isqrt_check.CALLS, isqrt_check.FIRST_CALLS, tr["batch"], isqrt_check.IMAGES))
        capture.probe(lambda: infer(host[0]).float().cpu())

    harness.reset_peak(dev)
    for i in range(tr["warmup"]):
        infer(host[i % len(host)]).float().cpu()

    traced = None
    if r.trace:
        with devtrace.spans(model):
            traced = devtrace.Trace(devtrace.profile(
                lambda i: infer(host[i % len(host)]).float().cpu(), tr["profile_steps"]),
                tr["profile_steps"])

    setup_s = r.setup_s()
    harness.log(harness.clock_line(dev, "before the window"))
    gc.freeze()  # set-up's objects out of the collector's way in the window
    outputs, times, failed = [], [], 0
    start = time.perf_counter()
    while True:
        k = len(times) % len(host)
        before = launches.read()
        if capture is not None:
            capture.arm(len(times))
        t0 = time.perf_counter()
        try:
            logits = infer(host[k]).float().cpu()
        except RuntimeError as exc:  # a call that raised never answers
            harness.log(f"call {len(times)} raised: {exc!r}")
            logits = None
        t1 = time.perf_counter()
        times.append(t1 - t0)
        launches.check(before, dev)
        if logits is None or not bool(torch.isfinite(logits).all()):
            failed += 1
        else:
            outputs.append((k, logits))
        if t1 - start >= r.seconds:
            break
    window_s = t1 - start
    clocks = harness.clock_line(dev, "after the window")
    gc.unfreeze()
    peak = harness.peak_bytes(dev)
    harness.log(clocks)
    harness.log(launches.summary())
    if capture is not None:
        capture.close()
        harness.sync(dev)
    del infer, model
    harness.free_device(dev)

    t_ref = time.perf_counter()
    refs = reference_logits(cell, harness.make_weights(cell, r.seed, dev), batches, dev)
    harness.log(f"reference: {time.perf_counter() - t_ref:.1f} s for {len(refs)} batches")
    numbers = {"logits_rel_l2": max((rel_l2(out, refs[k]) for k, out in outputs),
                                    default=math.inf)}
    if capture is not None:
        numbers[isqrt_check.NAME] = isqrt_check.worst(cell, capture.captured(), dev)
        harness.log(f"{isqrt_check.NAME}: {len(capture.captured())} sampled calls compared")
    check = harness.checks(numbers, cell.limits)
    correct = failed == 0 and launches.bad == 0 and harness.checks_pass(check)

    e2e = {"serve_images_per_s": tr["batch"] * len(outputs) / window_s,
           "serve_batch_ms_p95": 1e3 * p95(times) if len(times) > 1 else math.nan,
           "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s}
    result = harness.result(r, correct, len(times), failed, e2e, peak, traced, len(times),
                            window_s)
    return result, check
