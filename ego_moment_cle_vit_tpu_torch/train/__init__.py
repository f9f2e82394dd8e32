"""Training: the optimizer and train state, checkpoints, the train and eval
steps, the trainer and the evaluator."""

from .evaluator import Evaluator, classification_metrics
from .state import (
    Optimizer,
    TrainState,
    create_learning_rate_schedule,
    create_optimizer,
    create_train_state,
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)
from .step import make_eval_step, make_train_step, step_generators
from .trainer import Trainer

__all__ = [
    "Evaluator",
    "Optimizer",
    "TrainState",
    "Trainer",
    "classification_metrics",
    "create_learning_rate_schedule",
    "create_optimizer",
    "create_train_state",
    "latest_checkpoint_step",
    "make_eval_step",
    "make_train_step",
    "restore_checkpoint",
    "save_checkpoint",
    "step_generators",
]
