"""Config loading, device resolution and the flax <-> torch weight converters."""

from .config import load_config
from .convert import flax_tree_from_named_tensors, torch_state_dict_from_flax
from .device import resolve_device

__all__ = [
    "flax_tree_from_named_tensors",
    "load_config",
    "resolve_device",
    "torch_state_dict_from_flax",
]
