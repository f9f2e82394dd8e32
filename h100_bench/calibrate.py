"""Readings that set each cell's limits: the program's numbers over many
seeds, and the control's and the planted faults' over a few, at the cell's
own size, in one process.

    python3 h100_bench/calibrate.py --workload <name> --seeds 1,2,3 [--control 1,2,3] [--faults 1,2,3]

The program's readings go through the cell's own entry point and shapes
(``make_infer_fn`` on the ring's batches; ``make_train_step`` through the
checked steps), without the timed window.  The control is the reference in
float8 (e4m3) where the configuration computes in bfloat16, compared with
the float32 reference as the program is.  The training fault leaves half of
each batch out (the loss's mean over the other half); the serving fault runs
the program's iSQRT one Newton–Schulz step short.  Where the cell's limits
name ``isqrt_rel_l2``, the iSQRT output of 8 images of each ring batch is
read too (``isqrt_check.py``), with two controls of its own in the kernel's
place on the program's captured inputs: the reference's iteration with its
iterates stored in bfloat16 (``control.``) and with its products' operands
in TF32 (``tf32.``).  One JSON line a reading; the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fewer_steps(cell):
    """The cell with the moment head's iSQRT one step short (k - 1)."""
    spec = copy.deepcopy(cell.spec)
    moment = spec["port_config"]["model"]["moment"]
    moment["isqrt_iterations"] = moment.get("isqrt_iterations", 5) - 1
    return dataclasses.replace(cell, spec=spec)


def serve_logits(cell, weights, batches, device, seed=None) -> tuple:
    """The program's logits of each batch through ``make_infer_fn``, and,
    given a seed, the iSQRT captures of a sample of each batch's images."""
    from ego_moment_cle_vit_tpu_torch import make_infer_fn
    from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug
    from h100_bench import harness, isqrt_check

    model = harness.program_model(cell, weights, device)
    infer = make_infer_fn(model, harness.augment_config(cell, prog_aug), device=device)
    capture = None
    if seed is not None:
        capture = isqrt_check.Capture(model, isqrt_check.draw(
            seed, len(batches), len(batches), cell.traffic["batch"], 2 * isqrt_check.IMAGES))
        capture.probe(lambda: infer(batches[0]))
    outs = []
    for i, b in enumerate(batches):
        if capture is not None:
            capture.arm(i)
        outs.append(infer(b).float().cpu())
    captured = []
    if capture is not None:
        capture.close()
        harness.sync(device)
        captured = capture.captured()
    del infer, model, capture
    harness.free_device(device)
    return outs, captured


def serve_readings(cell, seed: int, device, control: bool, fault: bool = False) -> dict:
    from h100_bench import harness, isqrt_check
    from h100_bench.kinds.serve import reference_logits, rel_l2
    from h100_bench.weights import make_batches

    tr = cell.traffic
    batches, _ = make_batches(seed, tr["ring"], tr["batch"], cell.spec["input"]["resize_size"],
                              cell.spec["num_classes"], device)
    weights = harness.make_weights(cell, seed, device)
    isqrt = isqrt_check.wanted(cell)
    outs, captured = serve_logits(cell, weights, batches, device, seed if isqrt else None)
    t0 = time.perf_counter()
    refs = reference_logits(cell, weights, batches, device)
    out = {"reference_s": time.perf_counter() - t0,
           "logits_rel_l2": max(rel_l2(o, r) for o, r in zip(outs, refs))}
    if isqrt:
        out[isqrt_check.NAME] = isqrt_check.worst(cell, captured, device)
    if control:
        ctrl = reference_logits(cell, weights, batches, device, precision="fp8")
        out["control.logits_rel_l2"] = max(rel_l2(o, r) for o, r in zip(ctrl, refs))
        for prefix, precision in (("control", "bf16"), ("tf32", "tf32")) if isqrt else ():
            out[f"{prefix}.{isqrt_check.NAME}"] = max(isqrt_check.rel_l2(
                isqrt_check.reference(cell, t, g, device, precision),
                isqrt_check.reference(cell, t, g, device)) for t, g, _ in captured)
    if fault:
        short, short_captured = serve_logits(fewer_steps(cell), weights, batches, device,
                                             seed if isqrt else None)
        out["fewer_steps.logits_rel_l2"] = max(rel_l2(o, r) for o, r in zip(short, refs))
        if isqrt:
            out[f"fewer_steps.{isqrt_check.NAME}"] = isqrt_check.worst(cell, short_captured,
                                                                      device)
    del weights
    harness.free_device(device)
    return out


def program_steps(cell, seed: int, device, half: bool = False):
    """The program through the checked steps: (losses, first gradient norms,
    change norms); ``half`` leaves out the second half of every batch."""
    from ego_moment_cle_vit_tpu_torch import create_train_state, make_train_step
    from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug
    from h100_bench import harness
    from h100_bench.kinds.train import change_norms, first_gradient_norms
    from h100_bench.weights import generator, make_batches

    tr = cell.traffic
    batches, labels = make_batches(seed, tr["ring"], tr["batch"],
                                   cell.spec["input"]["resize_size"], cell.spec["num_classes"],
                                   device)
    weights = harness.make_weights(cell, seed, device)
    model = harness.program_model(cell, weights, device)
    state = create_train_state(model, cell.spec["port_config"], cell.spec["steps_per_epoch"],
                               device=device)
    step_fn = make_train_step(model, harness.augment_config(cell, prog_aug), device=device)
    gen = generator(seed, "steps", device)
    keep = tr["batch"] // 2 if half else tr["batch"]
    losses, first = [], None
    for k in range(tr["checked_steps"]):
        losses.append(float(step_fn(state, batches[k][:keep], labels[k][:keep], gen)))
        if k == 0:
            first = first_gradient_norms(state.optimizer)
    change = change_norms(state.optimizer, weights)
    del step_fn, state, model
    harness.free_device(device)
    return (losses, first, change), weights, batches, labels, gen.initial_seed()


def train_readings(cell, seed: int, device, control: bool, fault: bool) -> dict:
    from h100_bench import harness
    from h100_bench.kinds.train import compare, reference_steps

    prog, weights, batches, labels, step_seed = program_steps(cell, seed, device)
    t0 = time.perf_counter()
    ref = reference_steps(cell, weights, batches, labels, step_seed, device)
    out = {"reference_s": time.perf_counter() - t0, "program_losses": prog[0],
           "reference_losses": ref[0], **compare(prog, ref)}
    if control:
        ctrl = reference_steps(cell, weights, batches, labels, step_seed, device, "fp8")
        out.update({f"control.{k}": v for k, v in compare(ctrl, ref).items()},
                   control_losses=ctrl[0])
    if fault:
        half = program_steps(cell, seed, device, half=True)[0]
        out.update({f"half_batch.{k}": v for k, v in compare(half, ref).items()},
                   half_batch_losses=half[0])
    del weights, batches, labels
    harness.free_device(device)
    return out


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="", help="seeds that also read the control")
    p.add_argument("--faults", default="", help="seeds that also read the planted faults")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from h100_bench import harness

    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    harness.require_cards(cell.chips)
    harness.log(harness.card_line(device))
    harness.build_kernels(cell, device)
    control, faults = set(seeds(args.control)), set(seeds(args.faults))
    for seed in dict.fromkeys(seeds(args.seeds) + sorted(control | faults)):
        t0 = time.perf_counter()
        if cell.kind == "serve":
            out = serve_readings(cell, seed, device, seed in control, seed in faults)
        else:
            out = train_readings(cell, seed, device, seed in control, seed in faults)
        print(json.dumps({"workload": cell.name, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
