"""YAML config loading, saving and CLI overrides, compatible with
configs/ufg_base.yaml.

The port's copy of ``ego_moment_cle_vit_tpu/utils/config.py``; ``yaml`` is
imported where a file is read or written, so the package imports without
PyYAML.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Optional


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def save_config(config: Dict[str, Any], path: str) -> None:
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)


def merge_overrides(
    config: Dict[str, Any],
    *,
    batch_size: Optional[int] = None,
    lr: Optional[float] = None,
    epochs: Optional[int] = None,
    dataset: Optional[str] = None,
    backbone: Optional[str] = None,
    seed: Optional[int] = None,
) -> Dict[str, Any]:
    """A copy of ``config`` with the CLI overrides applied."""
    cfg = copy.deepcopy(config)
    if batch_size is not None:
        cfg.setdefault("training", {})["batch_size"] = batch_size
    if lr is not None:
        cfg.setdefault("training", {}).setdefault("optimizer", {})["lr"] = lr
    if epochs is not None:
        cfg.setdefault("training", {})["epochs"] = epochs
    if dataset is not None:
        cfg.setdefault("dataset", {})["name"] = dataset
    if backbone is not None:
        cfg.setdefault("model", {})["backbone_name"] = backbone
    if seed is not None:
        cfg.setdefault("experiment", {})["seed"] = seed
    return cfg
