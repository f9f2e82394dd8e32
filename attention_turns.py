#!/usr/bin/env python3
"""Time the attention kernels of this checkout against another's, in turns.

    python3 attention_turns.py --other DIR [--out FILE]

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``).  On one GPU, each turn is a fresh process that
imports the port from one checkout, builds its four attention kernels there
(all nvcc runs at once), and times, with CUDA events (median of 5 samples of
10 launches, after 3 warm-up launches), the attention kernels at the main
paths' calls, in bf16, and at two calls in fp32:

    3   packed attention forward   qkv [64, 1, 197, 2304], 12 heads (serving)
    3   packed attention forward   qkv [128, 1, 197, 2304], with lse (training)
    6   q-tiled attention forward  qkv [64, 785, 2304] and [128, 785, 2304], 12 heads
    6   q-tiled attention forward  qkv [64, 1025, 3072] and [128, 1025, 3072], 16 heads
    3b  packed attention backward  qkv [128, 1, 197, 2304], 12 heads
    6b  q-tiled attention backward qkv [128, 785, 2304], 12 heads
    6b  q-tiled attention backward qkv [128, 1025, 3072], 16 heads
    3, 6 in fp32 (off the main paths) at [8, 1, 197, 2304] and [4, 785, 2304]

and, in the same turn and process, SDPA (``scaled_dot_product_attention``,
forward or backward) on the same inputs, the library yardstick, whose own
spread across turns decides whether a kernel is at or under it.  Each turn
also hashes what its kernels return at every call (out and lse, or dqkv), from
the same seeded inputs, so the two checkouts are compared bit for bit too.

The turns run other, this, this, other, so that drift of the card hits both
alike.  Prints the card's name and power limit, each turn's times, the best
of each side, and a last line of JSON {"card": ..., "shapes": {shape:
{"other": [ms, ms], "this": [ms, ms], "sdpa": [ms, ms, ms, ms], "same_bits":
bool}}}; --out writes that JSON to a file too.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys

SHAPES = (("3 [64,1,197,2304] H12", "packed_fwd", 64, 197, 768, 12),
          ("3 [128,1,197,2304] H12 lse", "packed_fwd_lse", 128, 197, 768, 12),
          ("6 [64,785,2304] H12", "tiled_fwd", 64, 785, 768, 12),
          ("6 [128,785,2304] H12", "tiled_fwd", 128, 785, 768, 12),
          ("6 [64,1025,3072] H16", "tiled_fwd", 64, 1025, 1024, 16),
          ("6 [128,1025,3072] H16", "tiled_fwd", 128, 1025, 1024, 16),
          ("3b [128,1,197,2304] H12", "packed_bwd", 128, 197, 768, 12),
          ("6b [128,785,2304] H12", "tiled_bwd", 128, 785, 768, 12),
          ("6b [128,1025,3072] H16", "tiled_bwd", 128, 1025, 1024, 16),
          ("3 fp32 [8,1,197,2304] H12 lse", "packed_fwd_lse", 8, 197, 768, 12),
          ("6 fp32 [4,785,2304] H12", "tiled_fwd", 4, 785, 768, 12))
SOURCES = ("packed_attention_fwd", "flash_attention_fwd", "packed_attention_bwd",
           "flash_attention_bwd")
ORDER = ("other", "this", "this", "other")


def time_ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return statistics.median(times)


def digest(result) -> str:
    """sha256 of the bits of a kernel's result: a tensor, or a tuple of them
    (None entries skipped)."""
    import torch

    h = hashlib.sha256()
    for t in result if isinstance(result, tuple) else (result,):
        if t is not None:
            bits = {2: torch.int16, 4: torch.int32}[t.element_size()]  # read as integers
            h.update(t.contiguous().view(-1).view(bits).cpu().numpy().tobytes())
    return h.hexdigest()


def sdpa(qkv, heads: int, backward: bool):
    """SDPA on the same inputs, the forward or its backward (dq, dk, dv)."""
    import torch

    b, t, c3 = qkv.shape[0], qkv.shape[-2], qkv.shape[-1]
    d = c3 // 3 // heads
    x = qkv.reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = (x[i].contiguous().requires_grad_(backward) for i in range(3))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    if not backward:
        return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    do = torch.randn_like(o)
    return lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)


def worker() -> None:
    """One turn: time every shape with the port of the working directory (put
    ahead of this script's own directory, which Python searches first)."""
    sys.path.insert(0, os.getcwd())
    import torch

    from ego_moment_cle_vit_tpu_torch.kernels import _build
    from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as fa
    from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as pa

    _build.build(SOURCES)  # all four nvcc runs at once

    # the backward of earlier checkouts took no out and lse
    takes_lse = "lse" in inspect.signature(pa.packed_attention_bwd).parameters
    print(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(pa.__file__)))),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for name, kind, b, t, c, h in SHAPES:
        shape = (b, 1, t, 3 * c) if kind.startswith("packed") else (b, t, 3 * c)
        dtype = torch.float32 if "fp32" in name else torch.bfloat16
        qkv = torch.randn(*shape, generator=g, device="cuda").to(dtype)
        dout = torch.randn(*shape[:-1], c, generator=g, device="cuda").to(dtype)
        if kind == "packed_fwd":
            fn = lambda: pa.packed_attention_fwd(qkv, None, None, h)  # noqa: E731
        elif kind == "packed_fwd_lse":
            fn = lambda: pa.packed_attention_fwd(qkv, None, None, h, return_lse=True)  # noqa: E731
        elif kind == "tiled_fwd":
            fn = lambda: fa.flash_attention_tiled_fwd(qkv, h)  # noqa: E731
        elif kind == "packed_bwd" and takes_lse:
            out, lse = pa.packed_attention_fwd(qkv, None, None, h, return_lse=True)
            fn = lambda: pa.packed_attention_bwd(qkv, None, None, out, lse, dout, h)  # noqa: E731
        elif kind == "packed_bwd":
            fn = lambda: pa.packed_attention_bwd(qkv, None, None, dout, h)  # noqa: E731
        else:
            out, lse = fa.flash_attention_tiled_fwd(qkv, h)
            fn = lambda: fa.flash_attention_tiled_bwd(qkv, out, lse, dout, h)  # noqa: E731
        res[name] = time_ms(fn)
        res[name + " SDPA"] = time_ms(sdpa(qkv, h, kind.endswith("bwd")))
        res[name + " digest"] = digest(fn())
        del qkv, dout
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--out", help="also write the JSON result here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attention_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.worker:
        worker()
        return 0
    port = "ego_moment_cle_vit_tpu_torch"
    if not args.other or not os.path.isdir(os.path.join(args.other, port)):
        print("attention_turns: --other must name a checkout of this repository",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    trees = {"this": os.path.dirname(os.path.abspath(__file__)),
             "other": os.path.abspath(args.other)}
    result = {"card": card,
              "shapes": {name: {"other": [], "this": [], "sdpa": []} for name, *_ in SHAPES}}
    digests: dict = {}
    for turn in ORDER:
        env = {**os.environ, "PYTHONPATH": trees[turn]}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"],
                              cwd=trees[turn], env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        lines = proc.stdout.strip().splitlines()
        times = json.loads(lines[-1])
        if not lines[0].startswith(trees[turn]):
            print(f"the {turn} turn imported the port from {lines[0]}", file=sys.stderr)
            return 1
        for name, *_ in SHAPES:
            result["shapes"][name][turn].append(times[name])
            result["shapes"][name]["sdpa"].append(times[name + " SDPA"])
            digests.setdefault(name, {}).setdefault(turn, set()).add(times[name + " digest"])
        print(f"{turn:5s} " + "  ".join(f"{k}: {v:.4f} ms" for k, v in times.items()
                                         if not k.endswith("digest")), flush=True)
    for name, t in result["shapes"].items():
        d = digests[name]
        t["same_bits"] = len(d["this"]) == 1 and d["this"] == d["other"]
        print(f"{name}: {'the same bits' if t['same_bits'] else 'different bits'} in both "
              "checkouts")
        print(f"{name}: other {min(t['other']):.4f} ms, this {min(t['this']):.4f} ms "
              f"(this / other {min(t['this']) / min(t['other']):.3f}); SDPA "
              f"{min(t['sdpa']):.4f}-{max(t['sdpa']):.4f} ms (this / best SDPA "
              f"{min(t['this']) / min(t['sdpa']):.3f})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
