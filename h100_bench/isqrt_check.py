"""``isqrt_rel_l2``: the moment head's M2^-1/2 on the dense route (N >= D),
as the timed path computes it, held against the reference's.

The logits cannot see the iSQRT: most of M2 / tr's spectrum lies far below 1,
where k steps leave Y near 1.5^k I, and the LayerNorm after ``second_proj``
removes that scale.  So a cell whose limits name ``isqrt_rel_l2`` compares the
iSQRT's own output.  In the window, a sample of calls drawn from the seed
(``CALLS`` of the first ``FIRST_CALLS``, ``IMAGES`` images of each) has the
moment head's inputs (tokens, graph: a forward pre-hook on
``model.moment_head``) and its iSQRT's output (a wrapper around the head's
``_isqrt``) copied to pinned host memory, asynchronously on the call's
stream; every other call only passes through the wrapper.  After the window
the reference (``reference.model.dense_route_isqrt``) forms Zc, W Zc and M
from those inputs and runs the Newton–Schulz iteration, in float32, rounding
to the model's dtype what the head keeps in it (mu, Zc, W Zc, M, M^-1/2).
The number is the worst image's ||Y - Y_ref|| / ||Y_ref||.  The reference
follows the program from the head's inputs: the backbone and GPF before them
are the logits' to check.
"""

from __future__ import annotations

import math

import torch

NAME = "isqrt_rel_l2"
CALLS, IMAGES, FIRST_CALLS = 8, 4, 64
PROBE = "probe"


def wanted(cell) -> bool:
    return NAME in cell.limits


def draw(seed: int, calls: int, first_calls: int, batch: int, images: int) -> dict:
    """{call: [images]}: ``calls`` of the first ``first_calls`` calls and
    ``images`` of each call's batch, from the seed."""
    from h100_bench.weights import derive
    g = torch.Generator().manual_seed(derive(seed, "isqrt sample"))
    picked = sorted(torch.randperm(first_calls, generator=g)[:calls].tolist())
    return {c: sorted(torch.randperm(batch, generator=g)[:images].tolist()) for c in picked}


class Capture:
    """Copies of the head's inputs and iSQRT output on the sampled calls.
    ``probe()`` (one call in set-up) learns their shapes and types and pins
    the host buffers; ``arm(call)`` before each call; ``close()`` unhooks."""

    def __init__(self, model, sample: dict):
        self.sample, self.armed = sample, None
        self.meta, self.buffers, self.taken = {}, {}, set()
        self.head = model.moment_head
        self._inner = self.head._isqrt
        self.head._isqrt = self._isqrt
        self._hook = self.head.register_forward_pre_hook(self._inputs, with_kwargs=True)

    def probe(self, call_fn) -> None:
        self.armed = PROBE
        try:
            call_fn()
        finally:
            self.armed = None
        pin = next(self.head.parameters()).is_cuda
        for call, images in self.sample.items():
            self.buffers[call] = {
                name: torch.empty((len(images),) + shape, dtype=dtype, pin_memory=pin)
                for name, (shape, dtype) in self.meta.items()}

    def arm(self, call: int) -> None:
        self.armed = call if call in self.buffers else None

    def _keep(self, name: str, t: torch.Tensor) -> None:
        if self.armed is None:
            return
        if self.armed == PROBE:
            self.meta[name] = (tuple(t.shape[1:]), t.dtype)
            return
        buf = self.buffers[self.armed][name]
        for i, j in enumerate(self.sample[self.armed]):
            buf[i].copy_(t[j], non_blocking=True)
        if name == "y":
            self.taken.add(self.armed)

    def _inputs(self, module, args, kwargs):
        tokens = args[0] if args else kwargs["tokens"]
        graph = args[1] if len(args) > 1 else kwargs["graph"]
        self._keep("tokens", tokens)
        self._keep("graph", graph)

    def _isqrt(self, centered, weighted):
        out = self._inner(centered, weighted)
        self._keep("y", out)
        return out

    def close(self) -> None:
        self._hook.remove()
        del self.head._isqrt  # the class's method again
        self.armed = None

    def captured(self) -> list:
        """[(tokens, graph, y)] of every sampled call the window made."""
        return [(b["tokens"], b["graph"], b["y"]) for c, b in self.buffers.items()
                if c in self.taken]


def reference(cell, tokens, graph, device, precision="fp32", iterations=None):
    """The reference's M2^-1/2 of one captured call, on ``device``."""
    from h100_bench.reference.layers import fp32_products
    from h100_bench.reference.model import dense_route_isqrt
    moment = cell.spec["port_config"]["model"].get("moment", {})
    k = moment.get("isqrt_iterations", 5) if iterations is None else iterations
    stored = torch.bfloat16 if cell.spec["port_config"]["model"].get("bf16") else None
    with fp32_products():
        return dense_route_isqrt(tokens.to(device), graph.to(device), k, stored=stored,
                                 precision=precision)


def rel_l2(y: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst image's ||y - ref|| / ||ref||."""
    y, ref = y.float().flatten(1), ref.float().flatten(1)
    return float(((y - ref).norm(dim=1) / ref.norm(dim=1)).max())


def worst(cell, captured: list, device) -> float:
    """``isqrt_rel_l2`` over the captured calls (inf where none was)."""
    from h100_bench.flops import family_of
    arch = cell.spec["architecture"]
    if family_of(arch).tokens(arch) < arch["num_features"]:
        raise ValueError(f"{cell.name}: {NAME} compares the dense route (N >= D)")
    return max((rel_l2(y.to(device), reference(cell, tokens, graph, device))
                for tokens, graph, y in captured), default=math.inf)
