"""Training: the optimizer and train state, and the train step."""

from .state import (
    Optimizer,
    TrainState,
    create_learning_rate_schedule,
    create_optimizer,
    create_train_state,
)
from .step import make_train_step, step_generators

__all__ = [
    "Optimizer",
    "TrainState",
    "create_learning_rate_schedule",
    "create_optimizer",
    "create_train_state",
    "make_train_step",
    "step_generators",
]
