"""Config loading, seeding and model introspection, device resolution, and
the flax <-> torch and timm -> torch weight converters."""

from .config import load_config, merge_overrides, save_config
from .convert import flax_tree_from_named_tensors, torch_state_dict_from_flax
from .device import resolve_device
from .ops import count_parameters, get_model_info, print_model_info, set_seed

__all__ = [
    "count_parameters",
    "flax_tree_from_named_tensors",
    "get_model_info",
    "load_config",
    "merge_overrides",
    "print_model_info",
    "resolve_device",
    "save_config",
    "set_seed",
    "torch_state_dict_from_flax",
]
