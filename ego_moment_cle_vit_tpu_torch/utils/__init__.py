"""Config loading, device resolution and the flax -> torch weight converter."""

from .config import load_config
from .convert import torch_state_dict_from_flax
from .device import resolve_device

__all__ = ["load_config", "resolve_device", "torch_state_dict_from_flax"]
