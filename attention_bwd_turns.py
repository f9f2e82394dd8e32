#!/usr/bin/env python3
"""Time the attention kernels of this checkout against another's, in turns.

    python3 attention_bwd_turns.py --other DIR [--out FILE]

DIR is another checkout of this repository (for example the parent commit,
unpacked with ``git archive``).  On one GPU, each turn is a fresh process that
imports the port from one checkout, builds its kernels there, and times, with
CUDA events (median of 5 samples of 10 launches, after 3 warm-up launches),
the bf16 attention backward at the training calls of the main paths and
kernel 3's serving call:

    3b  packed attention backward  qkv [128, 1, 197, 2304], 12 heads
    6b  q-tiled attention backward qkv [128, 785, 2304], 12 heads
    6b  q-tiled attention backward qkv [128, 1025, 3072], 16 heads
    3   packed attention forward   qkv [64, 1, 197, 2304], 12 heads (serving)

The turns run other, this, this, other, so that drift of the card hits both
alike.  Prints the card's name and power limit, each turn's times, and a last
line of JSON {"card": ..., "shapes": {shape: {"other": [ms, ms], "this": [ms,
ms]}}}; --out writes that JSON to a file too.  Needs one GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

SHAPES = (("3b [128,1,197,2304] H12", "packed_bwd", 128, 197, 768, 12),
          ("6b [128,785,2304] H12", "tiled_bwd", 128, 785, 768, 12),
          ("6b [128,1025,3072] H16", "tiled_bwd", 128, 1025, 1024, 16),
          ("3 [64,1,197,2304] H12", "packed_fwd", 64, 197, 768, 12))
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


def worker() -> None:
    """One turn: time every shape with the port of the working directory (put
    ahead of this script's own directory, which Python searches first)."""
    sys.path.insert(0, os.getcwd())
    import torch

    from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as fa
    from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as pa

    # the backward of earlier checkouts took no out and lse
    takes_lse = "lse" in inspect.signature(pa.packed_attention_bwd).parameters
    print(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(pa.__file__)))),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for name, kind, b, t, c, h in SHAPES:
        shape = (b, 1, t, 3 * c) if kind.startswith("packed") else (b, t, 3 * c)
        qkv = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
        dout = torch.randn(*shape[:-1], c, generator=g, device="cuda").to(torch.bfloat16)
        if kind == "packed_fwd":
            fn = lambda: pa.packed_attention_fwd(qkv, None, None, h)  # noqa: E731
        elif kind == "packed_bwd" and takes_lse:
            out, lse = pa.packed_attention_fwd(qkv, None, None, h, return_lse=True)
            fn = lambda: pa.packed_attention_bwd(qkv, None, None, out, lse, dout, h)  # noqa: E731
        elif kind == "packed_bwd":
            fn = lambda: pa.packed_attention_bwd(qkv, None, None, dout, h)  # noqa: E731
        else:
            out, lse = fa.flash_attention_tiled_fwd(qkv, h)
            fn = lambda: fa.flash_attention_tiled_bwd(qkv, out, lse, dout, h)  # noqa: E731
        res[name] = time_ms(fn)
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
        print("attention_bwd_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.worker:
        worker()
        return 0
    port = "ego_moment_cle_vit_tpu_torch"
    if not args.other or not os.path.isdir(os.path.join(args.other, port)):
        print("attention_bwd_turns: --other must name a checkout of this repository",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    trees = {"this": os.path.dirname(os.path.abspath(__file__)),
             "other": os.path.abspath(args.other)}
    result = {"card": card, "shapes": {name: {"other": [], "this": []} for name, *_ in SHAPES}}
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
        for name, ms in times.items():
            result["shapes"][name][turn].append(ms)
        print(f"{turn:5s} " + "  ".join(f"{k}: {v:.4f} ms" for k, v in times.items()), flush=True)
    for name, t in result["shapes"].items():
        print(f"{name}: other {min(t['other']):.4f} ms, this {min(t['this']):.4f} ms "
              f"(this / other {min(t['this']) / min(t['other']):.3f})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
