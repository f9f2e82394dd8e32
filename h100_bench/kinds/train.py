"""Training: ``make_train_step``'s ``train_step`` on uint8 batches and labels
already on the device (as the trainer's device cache hands them over), drawn
from a ring of distinct seeded batches.

Set-up builds one train state and drives it through its first
``checked_steps`` steps on distinct batches, through the same call and feed
as the window; the window then continues on that same state until
``--seconds`` have passed, and ends at a synchronize.  Afterwards the
reference repeats the first steps from the same weights, batches and seeds,
and the run compares the first step's gradient norm by leaf (from the
optimizer's state after that step) and each leaf's change over the checked
steps.

Traffic parameters: ``batch``, ``ring``, ``checked_steps``, ``warmup``
(further steps before the window), ``profile_steps``.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from h100_bench import devtrace, harness
from h100_bench.weights import generator, make_batches

_MASK64 = (1 << 64) - 1


def mix(seed: int, step: int, purpose: int) -> int:
    """splitmix64 of (seed, step, purpose): how a train step seeds its
    augmentation (purpose 0) and dropout (purpose 1) streams from the
    generator it is given."""
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + purpose + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def parts(name: str, leaf: torch.Tensor):
    """(name, tensor) of the parts of a leaf whose norms are compared: the
    leaf itself, or the q, k and v thirds of a qkv bias (the key's bias has
    no gradient under softmax, and the rule that leaves such parts out of the
    change reads the reference's gradient part by part)."""
    if name.endswith("qkv.bias"):
        return [(f"{name}[{k}]", t) for k, t in zip("qkv", leaf.chunk(3))]
    return [(name, leaf)]


def first_gradient_norms(opt) -> dict:
    """Each leaf's (part's) gradient norm as the optimizer took it in its
    first update, from its state after that update: m = (1 - b1) g for
    Adam's leaves; for a factored leaf, v_row = mean over the columns of
    g^2 + eps^2."""
    norms = {}
    for name, m in opt.m.items():
        for part, t in parts(name, m):
            norms[part] = float(t.norm()) / (1.0 - opt.b1)
    for name in opt.factored:
        cols = opt.params[name].shape[opt.factored_axes[name][1]]
        sq = (opt.v_row[name].double() - opt.eps ** 2).clamp(min=0).sum() * cols
        norms[name] = float(sq.sqrt())
    return norms


@torch.no_grad()
def change_norms(opt, weights: dict) -> dict:
    """Each leaf's distance from its initial weights, as the optimizer holds
    it (the fp32 master of a bf16 leaf)."""
    return {part: float(t.norm()) for n, p in opt.params.items()
            for part, t in parts(n, opt.master.get(n, p).float() - weights[n].float())}


def gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median) for n in names}


def worst(by_leaf: dict) -> tuple[float, str]:
    """The largest gap and its leaf; a gap that is not a number counts as
    the largest."""
    at = max(by_leaf, key=lambda n: math.inf if math.isnan(by_leaf[n]) else by_leaf[n])
    return by_leaf[at], at


def reference_steps(cell, weights, batches, labels, step_seed, device, precision="fp32"):
    """The reference through the checked steps: (losses, first gradient norms
    by leaf, change norms by leaf)."""
    from h100_bench.reference import augment as ref_aug
    from h100_bench.reference.layers import Dense, fp32_products
    from h100_bench.reference.optim import RefOptimizer
    ref = harness.loaded_reference(cell, weights, precision, device)
    aug = harness.augment_config(cell, ref_aug)
    params = dict(ref.named_parameters())
    dense = {f"{p}.weight" for p, m in ref.named_modules() if isinstance(m, Dense)}
    opt = RefOptimizer(params, dense, cell.spec["port_config"]["training"],
                       cell.spec["steps_per_epoch"])
    losses, first = [], {}

    def record(name, g):
        if len(losses) == 1:
            first.update((part, float(t.norm())) for part, t in parts(name, g))

    with fp32_products():
        for step in range(cell.traffic["checked_steps"]):
            aug_gen, drop_gen = (torch.Generator(device=device).manual_seed(
                mix(step_seed, step, purpose)) for purpose in (0, 1))
            anchor, positive = ref_aug.dual_view_train_batch(batches[step], aug_gen, aug)
            losses.append(float(ref.loss_and_grads(anchor, positive, labels[step], drop_gen)))
            opt.step(record)
    with torch.no_grad():
        change = {part: float(t.norm()) for n, p in params.items()
                  for part, t in parts(n, p - weights[n].float())}
    del ref, opt, params
    harness.free_device(device)
    return losses, first, change


def compare(prog: tuple, ref: tuple) -> dict:
    """The numbers ``correct`` may compare (the cell's limits file says which
    it does)."""
    (p_loss, p_first, p_change), (r_loss, r_first, r_change) = prog, ref
    # the losses are logged, not compared: the float8 control reads under
    # the program on some seeds at step 1, and from step 2 on the program
    # runs on parameters rounded to bf16, a rounding the size of an update
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(p_loss, r_loss)]
    harness.log(f"loss gaps by step {loss_gaps}")
    names = sorted(r_first)
    grad = gaps(p_first, r_first, names)
    # leaves the reference gives no gradient to rounding move by round-off
    # alone; they are left out of the change by their reference gradient
    floor = 1e-3 * statistics.median(r_first[n] for n in names)
    moving = [n for n in names if r_first[n] >= floor]
    change = gaps(p_change, r_change, moving)
    (grad_gap, grad_at), (change_gap, change_at) = worst(grad), worst(change)
    harness.log(f"worst leaves: first gradient {grad_at}, change {change_at}; "
                f"{len(names) - len(moving)} leaves without a reference gradient left out "
                "of the change")
    return {"first_loss_rel_gap": loss_gaps[0], "first_grad_norm_gap": grad_gap,
            "change_norm_gap": change_gap,
            "median_first_grad_norm_gap": statistics.median(grad.values()),
            "median_change_norm_gap": statistics.median(change.values())}


def run(r: harness.Run):
    from ego_moment_cle_vit_tpu_torch import create_train_state, make_train_step
    from ego_moment_cle_vit_tpu_torch.data import augment as prog_aug

    cell, dev, tr = r.cell, r.device, r.cell.traffic
    harness.build_kernels(cell, dev)
    weights = harness.make_weights(cell, r.seed, dev)
    model = harness.program_model(cell, weights, dev)
    del weights  # made again from the seed where needed: not resident in the window
    harness.free_device(dev)
    state = create_train_state(model, cell.spec["port_config"], cell.spec["steps_per_epoch"],
                               device=dev)
    step_fn = make_train_step(model, harness.augment_config(cell, prog_aug), device=dev)
    size = cell.spec["input"]["resize_size"]
    batches, labels = make_batches(r.seed, tr["ring"], tr["batch"], size,
                                   cell.spec["num_classes"], dev)
    steps_gen = generator(r.seed, "steps", dev)
    launches = harness.Launches(cell)
    opt = state.optimizer
    harness.log(harness.card_line(dev))

    def step(k: int) -> torch.Tensor:
        return step_fn(state, batches[k % len(batches)], labels[k % len(labels)], steps_gen)

    harness.reset_peak(dev)
    checked = tr["checked_steps"]
    p_loss, p_first = [], None
    for k in range(checked):
        before = launches.read()
        p_loss.append(float(step(k)))
        launches.check(before, dev)
        if k == 0:
            p_first = first_gradient_norms(opt)
    p_change = change_norms(opt, harness.make_weights(cell, r.seed, dev))
    done = checked
    for _ in range(tr["warmup"]):
        step(done)
        done += 1

    traced = None
    if r.trace:
        with devtrace.spans(model, opt):
            traced = devtrace.Trace(devtrace.profile(lambda i: step(done + i),
                                                     tr["profile_steps"]), tr["profile_steps"])
        done += tr["profile_steps"]

    setup_s = r.setup_s()
    skipped0 = opt.total_notfinite
    harness.log(harness.clock_line(dev, "before the window"))
    gc.freeze()  # set-up's objects out of the collector's way in the window
    losses, raised = [], 0
    start = time.perf_counter()
    while True:
        before = launches.read()
        try:
            losses.append(step(done))
        except RuntimeError as exc:
            harness.log(f"step {done} raised: {exc!r}")
            raised += 1
        launches.check(before, dev)
        done += 1
        if time.perf_counter() - start >= r.seconds:
            break
    harness.sync(dev)
    window_s = time.perf_counter() - start
    clocks = harness.clock_line(dev, "after the window")
    gc.unfreeze()
    peak = harness.peak_bytes(dev)
    attempted = len(losses) + raised
    nonfinite = int((~torch.isfinite(torch.stack(losses).float())).sum()) if losses else 0
    failed = raised + nonfinite + (opt.total_notfinite - skipped0)
    harness.log(clocks)
    harness.log(launches.summary())
    harness.log(f"program losses of the checked steps {p_loss}")
    del step_fn, state, model, opt, losses, step
    harness.free_device(dev)

    t_ref = time.perf_counter()
    weights = harness.make_weights(cell, r.seed, dev)
    ref = reference_steps(cell, weights, batches, labels, steps_gen.initial_seed(), dev)
    harness.log(f"reference losses of the checked steps {ref[0]} "
                f"({time.perf_counter() - t_ref:.1f} s)")
    numbers = compare((p_loss, p_first, p_change), ref)
    check = harness.checks(numbers, cell.limits)
    correct = failed == 0 and launches.bad == 0 and harness.checks_pass(check)

    e2e = {"train_images_per_s": tr["batch"] * (attempted - raised) / window_s,
           "peak_mem_gib": peak / harness.GIB, "setup_s": setup_s}
    result = harness.result(r, correct, attempted, failed, e2e, peak, traced, attempted,
                            window_s)
    return result, check
