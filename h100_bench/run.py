"""Run one cell of the benchmark and print its result as the last line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program
(``ego_moment_cle_vit_tpu_torch``) and ``BENCHMARK.json``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a profiled stretch.  Exits non-zero, printing no result, without enough
cards, when a file is missing, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from h100_bench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
        harness.require_cards(cell.chips)
    except (harness.SetupError, OSError, KeyError, ValueError) as exc:
        print(f"h100_bench: {exc}", file=sys.stderr)
        return 2
    result, check = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"h100_bench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result, check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
