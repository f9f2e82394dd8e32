"""YAML config loading, compatible with configs/ufg_base.yaml.

The port's copy of ``load_config`` from ``ego_moment_cle_vit_tpu/utils/config.py``;
``yaml`` is imported where a file is read, so the package imports without PyYAML.
"""

from __future__ import annotations

from typing import Any, Dict


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)
