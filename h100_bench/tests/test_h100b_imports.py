"""What the reference and the run may load."""

from __future__ import annotations

import subprocess
import sys

from h100b_tiny import ROOT

from h100_bench import harness

REFERENCE = ("h100_bench.reference.model", "h100_bench.reference.layers",
             "h100_bench.reference.families.swin", "h100_bench.reference.families.vit",
             "h100_bench.reference.augment", "h100_bench.reference.optim", "h100_bench.weights")


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; " + "; ".join(f"import {m}" for m in REFERENCE)
            + "; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "ego_moment_cle_vit_tpu",
                      "ego_moment_cle_vit_tpu_torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    """The port's name begins with the JAX package's: only a whole top-level
    name counts."""
    for name in ("jax", "jaxlib", "flax", "ego_moment_cle_vit_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "ego_moment_cle_vit_tpu_torch.fake", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "ego_moment_cle_vit_tpu.models", object())
    assert harness.forbidden_loaded() == ["ego_moment_cle_vit_tpu"]
