"""The benchmark's core: a cell from ``BENCHMARK.json``, set-up, the guards
and the result line.  Everything that belongs to one configuration, traffic
mix, per-layer metric or kernel lives in a file of its own, found by name:

* ``configs/<file>``: the model as run (``port_config`` for the program's
  ``create_model`` / ``create_train_state``, ``architecture`` with the
  published widths for the FLOP model, the reference and the kernels' work,
  input sizes, the kernels and their launches a forward or step);
* ``traffic/<traffic>.json``: the loop's kind (``kinds/<kind>.py``) and its
  parameters (batch, ring of distinct batches, profiled steps);
* ``limits/<cell>.json``: the limit of every number ``correct`` compares;
* ``layer_metrics/<metric>.py``, ``kernel_work/<wrapper>.py``,
  ``flops/<family>.py``, ``reference/families/<family>.py``.

The program under test is ``ego_moment_cle_vit_tpu_torch``; nothing here
imports JAX or the JAX package, and every run ends by checking that neither
was loaded.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ego_moment_cle_vit_tpu")
GIB = 2.0 ** 30


class SetupError(RuntimeError):
    """The run cannot start: no card, too few cards, or a missing file."""


@dataclasses.dataclass
class Cell:
    name: str
    bench_dir: Path         # the benchmark's folder in this checkout
    spec: dict              # the configuration file
    traffic: dict           # the traffic file
    chips: int
    limits: dict            # {number: limit}
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reported_in(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    spec = json.loads((root / config["file"]).read_text())
    bench_dir = root / BENCH_DIR.name
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported_in(m, name, names)]
    return Cell(name, bench_dir, spec, traffic, int(w["chips"]), limits, e2e, per_layer)


# ----------------------------------------------------------------------------
# the device
# ----------------------------------------------------------------------------


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise SetupError("torch.cuda.is_available() is false: the benchmark runs on a card")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")


def _smi(query: str) -> list[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "card: none (CPU run)"
    smi = _smi("name,power.limit,clocks.max.sm")
    return f"card: {torch.cuda.get_device_name(device)}; nvidia-smi: {smi[0] if smi else 'n/a'}"


def clock_line(device: torch.device, when: str) -> str:
    """SM clock, power draw and temperature, one ``nvidia-smi`` reading
    (taken beside the window, not inside it)."""
    if device.type != "cuda":
        return f"clocks {when}: not read (CPU run)"
    smi = _smi("clocks.sm,power.draw,temperature.gpu")
    return f"clocks {when} (SM, power, temperature): {smi[0] if smi else 'n/a'}"


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# kernels: build, launch counters, their work
# ----------------------------------------------------------------------------


def load_file(path: Path):
    """A module from a file whose name need not be an identifier."""
    name = "h100_bench_file_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_module(wrapper: str):
    return importlib.import_module(f"h100_bench.kernel_work.{wrapper}")


@dataclasses.dataclass
class KernelWork:
    wrapper: str
    module: object            # the kernel_work file
    bound_s_per_step: float   # its launches' least time a batch or step


def kernel_work(cell: Cell) -> list:
    from h100_bench.kernel_work import bound_s, dtype_name
    serving = cell.kind == "serve"
    out = []
    for wrapper, per_step in cell.spec["kernels"][cell.kind].items():
        mod = kernel_module(wrapper)
        layers = mod.work(cell.spec, cell.traffic["batch"], serving)
        # a wrapper may run more than once a layer (the recompute under block
        # checkpointing runs the forward kernel again): each launch is a
        # layer's work
        reps = per_step / len(layers)
        if reps != int(reps):
            raise SetupError(f"{wrapper}: {per_step} launches a step over {len(layers)} layers")
        # a kernel that computes in another type than the model's names it
        dtype = getattr(mod, "DTYPE", dtype_name(cell.spec))
        bound = sum(bound_s(b, f, dtype) for b, f in layers) * reps
        out.append(KernelWork(wrapper, mod, bound))
    return out


def build_kernels(cell: Cell, device: torch.device) -> None:
    """Build this cell's kernels (nvcc, all at once) into the program's own
    build directory inside the checkout; later runs load them from there."""
    if device.type != "cuda":
        return
    from ego_moment_cle_vit_tpu_torch.kernels import _build
    _build.build(tuple(kernel_module(w).SOURCE for w in cell.spec["kernels"][cell.kind]))


class Launches:
    """The program's ``<wrapper>.launches`` counters of this cell's kernels."""

    def __init__(self, cell: Cell):
        self.expected = dict(cell.spec["kernels"][cell.kind])
        self.fns = {}
        for wrapper in self.expected:
            mod_name, fn = kernel_module(wrapper).WRAPPER.split(":")
            self.fns[wrapper] = getattr(importlib.import_module(mod_name), fn)
        self.bad = 0
        self.seen = {}

    def read(self) -> dict:
        return {w: fn.launches for w, fn in self.fns.items()}

    def check(self, before: dict, device: torch.device) -> bool:
        """Compare one batch's or step's launches (since ``before``) with the
        configuration's; on the CPU the plain versions launch nothing."""
        got = {w: n - before[w] for w, n in self.read().items()}
        key = json.dumps(got, sort_keys=True)
        self.seen[key] = self.seen.get(key, 0) + 1
        ok = device.type != "cuda" or got == self.expected
        self.bad += not ok
        return ok

    def summary(self) -> str:
        return (f"launches expected a batch or step {json.dumps(self.expected, sort_keys=True)};"
                f" seen {self.seen}; differing {self.bad}")


# ----------------------------------------------------------------------------
# the program and the reference on the same weights
# ----------------------------------------------------------------------------


def reference_model(cell: Cell, precision: str, device: torch.device):
    from h100_bench.reference.model import RefModel
    return RefModel(cell.spec, precision).to(device)


def weight_plan(cell: Cell):
    """(shapes, served dtypes, norm leaves) of every leaf, from the
    reference's module tree."""
    from h100_bench.reference.layers import LayerNorm, served_dtypes
    with torch.device("meta"):
        ref = reference_model(cell, "fp32", torch.device("meta"))
    model_dtype = torch.bfloat16 if cell.spec["port_config"]["model"].get("bf16") else torch.float32
    shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    norms = {f"{p}.{n}" for p, m in ref.named_modules() if isinstance(m, LayerNorm)
             for n in ("weight", "bias")}
    return shapes, served_dtypes(ref, model_dtype), norms


def make_weights(cell: Cell, seed: int, device: torch.device) -> dict:
    from h100_bench.weights import make_weights as make
    shapes, dtypes, norms = weight_plan(cell)
    return make(shapes, dtypes, norms, seed, device)


def program_model(cell: Cell, weights: dict, device: torch.device):
    """The program's model through its entry point, then the benchmark's
    weights; every leaf must land in the dtype the plan serves it in."""
    from ego_moment_cle_vit_tpu_torch import create_model
    model = create_model(cell.spec["port_config"], cell.spec["num_classes"], device=device)
    model.load_state_dict(weights, strict=True)
    for name, t in model.state_dict().items():
        if name in weights and t.dtype != weights[name].dtype:
            raise SetupError(f"{name}: the program holds {t.dtype}, the plan serves "
                             f"{weights[name].dtype}")
    return model


def loaded_reference(cell: Cell, weights: dict, precision: str, device: torch.device):
    ref = reference_model(cell, precision, device)
    ref.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True)
    return ref


def augment_config(cell: Cell, module):
    data = cell.spec["input"]
    return module.AugmentConfig(input_size=data["input_size"], resize_size=data["resize_size"])


# ----------------------------------------------------------------------------
# numbers compared, the traced run, the result line
# ----------------------------------------------------------------------------


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers the cell's limits file
    names (each must be there); a number over its limit, or not finite,
    fails.  The others are logged, not compared."""
    for name in sorted(set(numbers) - set(limits)):
        log(f"not compared: {name} = {numbers[name]!r}")
    return {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}


def checks_pass(ch: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in ch.values())


@dataclasses.dataclass
class TracedRun:
    """What a per-layer reader sees."""
    trace: object               # devtrace.Trace
    kernel_work: list
    flops_per_step: float
    window_steps: int
    window_s: float
    device_type: str


def per_layer_metrics(cell: Cell, ctx: TracedRun) -> dict:
    out = {}
    for m in cell.per_layer:
        value = load_file(cell.bench_dir / "layer_metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def flops_per_step(cell: Cell) -> float:
    """Model FLOPs of one serving batch or one training step (three training
    forwards)."""
    from h100_bench.flops import family_of
    from h100_bench.flops.heads import heads_flops
    arch = cell.spec["architecture"]
    family = family_of(arch)
    b = cell.traffic["batch"]
    n = family.tokens(arch)
    if cell.kind == "serve":
        return family.forward_flops(arch, b) + heads_flops(cell.spec, b, n, training=False)
    return 3.0 * (family.forward_flops(arch, 2 * b) + heads_flops(cell.spec, b, n, training=True))


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def emit(result: dict, check: dict) -> None:
    """The numbers compared on standard error's last lines, then the result
    as standard output's last line, ``checks`` its last key."""
    sys.stdout.flush()
    for name, c in check.items():
        log(f"compared {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps({**result, "checks": check}), flush=True)


def result(r: "Run", correct: bool, attempted: int, failed: int, e2e: dict, peak: int,
           traced, window_steps: int, window_s: float) -> dict:
    """The result line without its checks: the end-to-end metrics of this
    cell (``e2e`` has them by name), or with ``--trace 1`` its per-layer
    metrics and the breakdown of the profiled stretch."""
    cell, dev = r.cell, r.device
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if traced is None:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    else:
        ctx = TracedRun(traced, kernel_work(cell), flops_per_step(cell), window_steps, window_s,
                        dev.type)
        out["metrics"] = per_layer_metrics(cell, ctx)
    out["device"] = device_block(dev, peak, traced)
    if traced is not None:
        out["breakdown"] = {"device_ops": traced.top_device_ops(),
                            "idle_gaps": traced.idle_gaps()}
    return out


def device_block(device: torch.device, peak: int, traced=None) -> dict:
    if device.type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1}
    block["memory_peak_bytes"] = peak
    if traced is not None:
        block["busy_s"] = traced.busy_s
        block["window_s"] = traced.window_s
    return block


@dataclasses.dataclass
class Run:
    """One process's run of a cell."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float

    def setup_s(self) -> float:
        return time.perf_counter() - self.t_start


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> tuple[dict, dict]:
    """Run the cell's kind; returns (result without checks, checks)."""
    kind = importlib.import_module(f"h100_bench.kinds.{cell.kind}")
    return kind.run(Run(cell, seed, seconds, trace, device, t_start))
