"""The traced stretch: spans around the layers, torch.profiler, and the
reduction of its trace to what the per-layer metrics read.

Spans come from the benchmark's own hooks, not from the program: forward pre-
and post-hooks open and close a ``record_function`` range around each module
of ``SPAN_MODULES``, and a wrapper on the train state's ``optimizer.step``
around each update.  A device operation belongs to a span when the host
launched it inside the span (launch and operation share the profiler's
correlation id).  Every name the harness records starts with ``h100b.``.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from contextlib import contextmanager

import torch

PREFIX = "h100b."
# span name -> the model's submodule it wraps
SPAN_MODULES = {"backbone": "backbone.backbone", "gpf": "gpf", "moment_head": "moment_head",
                "classifier": "classifier"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@contextmanager
def spans(model: torch.nn.Module, optimizer=None):
    """Record a range around every forward of the span modules (and every
    ``optimizer.step``) while inside."""
    handles, open_ranges = [], []
    for name, path in SPAN_MODULES.items():
        mod = model.get_submodule(path)

        def pre(_m, _a, _name=name):
            rf = torch.autograd.profiler.record_function(PREFIX + _name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(_m, _a, _o):
            open_ranges.pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    if optimizer is not None:
        step = optimizer.step

        def wrapped(*args, **kwargs):
            with torch.autograd.profiler.record_function(PREFIX + "optimizer"):
                return step(*args, **kwargs)

        optimizer.step = wrapped
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        if optimizer is not None:
            del optimizer.step  # the class's method again


def profile(fn, steps: int) -> dict:
    """Run ``fn(i)`` for i < steps under the profiler, each in a
    ``h100b.step`` range, the whole (ending in a synchronize) in
    ``h100b.stretch``; returns the trace's events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.autograd.profiler.record_function(PREFIX + "stretch"):
            for i in range(steps):
                with torch.autograd.profiler.record_function(PREFIX + "step"):
                    fn(i)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str, width: int = 80) -> str:
    """A device operation's name without its argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the first '(' outside template brackets
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


class Trace:
    """The profiled stretch, reduced.  Times in seconds."""

    def __init__(self, trace: dict, steps: int):
        events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
        self.steps = steps
        stretch = [e for e in events if e.get("name") == PREFIX + "stretch"]
        if not stretch:
            raise RuntimeError("the trace holds no stretch range")
        s = stretch[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        launch_ts = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch_ts[e["args"]["correlation"]] = float(e["ts"])
        self.device = []  # (start, end, name, launch ts or None)
        for e in events:
            if e.get("cat") in DEVICE_CATS:
                ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
                if ts + dur < self.t0 or ts > self.t1:
                    continue
                corr = e.get("args", {}).get("correlation")
                self.device.append((ts, ts + dur, e.get("name", "?"), launch_ts.get(corr)))
        self.ranges = {}
        for e in events:
            name = e.get("name", "")
            if e.get("cat") == "user_annotation" and name.startswith(PREFIX):
                self.ranges.setdefault(name[len(PREFIX):], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                       e.get("name", "?")) for e in events
                      if e.get("cat") in HOST_CATS and not e.get("name", "").startswith(PREFIX))
        self._host = host
        self._host_starts = [h[0] for h in host]
        self.busy_intervals = _union([(max(s, self.t0), min(e, self.t1))
                                      for s, e, _, _ in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) * 1e-6

    def device_s_under(self, span: str) -> float | None:
        """Device seconds of the operations launched inside ``span``'s ranges,
        or None when the span never ran."""
        ranges = sorted(self.ranges.get(span, []))
        if not ranges:
            return None
        starts = [r[0] for r in ranges]
        total = 0.0
        for s, e, _, lts in self.device:
            if lts is None:
                continue
            i = bisect.bisect_right(starts, lts) - 1
            if i >= 0 and lts <= ranges[i][1]:
                total += e - s
        return total * 1e-6

    def device_s_matching(self, pattern: str) -> tuple[float, int]:
        """Device seconds and count of the operations whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, name, _ in self.device if rx.search(name)]
        return sum(hits) * 1e-6, len(hits)

    def top_device_ops(self, n: int = 10) -> list:
        totals = {}
        for s, e, name, _ in self.device:
            key = short_name(name)
            totals[key] = totals.get(key, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]

    def _host_label(self, t: float) -> str:
        """The innermost host operation running at time t."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - 4000, -1), -1):
            s, e, name = self._host[j]
            if e >= t:
                return name
        return "(host between operations)"

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time inside the stretch, summed by the host operation
        running in the middle of each gap; the largest ``n``."""
        edges = [self.t0] + [x for iv in self.busy_intervals for x in iv] + [self.t1]
        totals = {}
        for k in range(0, len(edges), 2):
            s, e = edges[k], edges[k + 1]
            if e > s:
                label = self._host_label(0.5 * (s + e))
                totals[label] = totals.get(label, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]
