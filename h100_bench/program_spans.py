"""The program's own spans in a traced stretch, reduced for the per-layer
metrics that read them.

The program under test records a range named ``emct.<name>`` at its layer
boundaries while a profiler runs (``ego_moment_cle_vit_tpu_torch/utils/
trace.py``): the phases of ``train_step``, the optimizer's host read, the
serving call and its preprocessing, the model's layers and each kernel
wrapper's launch.  ``devtrace.Trace`` keeps them among its host events, with
their start and end; this file reads them from a ``Trace`` and changes
nothing of it.  A program that records no such span gives no ranges, and
every reader here returns None.

A device operation lies under a span when the host launched it inside one of
the span's ranges, by the launch's time stamp (as ``Trace.device_s_under``
attributes them), so operations launched from the autograd thread during
``loss.backward()`` count under the main thread's ``train.backward``.
Times in the trace are microseconds; what the readers return is
milliseconds a profiled step or call.
"""

from __future__ import annotations

import bisect

from h100_bench.devtrace import _union

PREFIX = "emct."


def ranges(trace, name: str) -> list:
    """The (start, end) of every range of the span ``emct.<name>``, sorted;
    empty when the span never ran."""
    full = PREFIX + name
    return sorted((s, e) for s, e, n in trace._host if n == full)


def _clip(intervals, t0: float, t1: float) -> list:
    return [[max(s, t0), min(e, t1)] for s, e in intervals if e > t0 and s < t1]


def _intersect(a, b) -> list:
    """The overlap of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a, b) -> list:
    """``a`` less ``b``, both sorted lists of disjoint intervals."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def device_s_under(trace, name: str) -> float | None:
    """Device seconds of the operations launched inside the span's ranges,
    or None when the span never ran."""
    spans = _union(ranges(trace, name))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for s, e, _, lts in trace.device:
        if lts is None:
            continue
        i = bisect.bisect_right(starts, lts) - 1
        if i >= 0 and lts <= spans[i][1]:
            total += e - s
    return total * 1e-6


def host_s_in(trace, name: str) -> float | None:
    """Host seconds inside the span's ranges (their union, within the
    stretch), or None when the span never ran."""
    spans = _union(ranges(trace, name))
    if not spans:
        return None
    return _length(_clip(spans, trace.t0, trace.t1)) * 1e-6


def idle_s_in(trace, name: str, outside: str | None = None) -> float | None:
    """Seconds of the stretch in which the device ran nothing (the complement
    of ``Trace.busy_intervals``) that lie inside the span's ranges and, given
    ``outside``, outside that span's ranges; None when the span never ran."""
    spans = _union(ranges(trace, name))
    if not spans:
        return None
    edges = [trace.t0] + [x for iv in trace.busy_intervals for x in iv] + [trace.t1]
    idle = [[edges[k], edges[k + 1]] for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    inside = _intersect(idle, _clip(spans, trace.t0, trace.t1))
    if outside is not None:
        inside = _subtract(inside, _union(ranges(trace, outside)))
    return _length(inside) * 1e-6


def per_step_ms(seconds: float | None, trace) -> float | None:
    """Milliseconds a profiled step or call."""
    return None if seconds is None else 1e3 * seconds / trace.steps
