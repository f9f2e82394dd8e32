"""The training step: augment, forward, five-term loss, backward, update.

Counterpart of ``ego_moment_cle_vit_tpu/bench_core.py:28-57``
(``make_train_step``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..data.augment import AugmentConfig, dual_view_train_batch
from ..utils.device import pin_fp32_precision, resolve_device
from .state import TrainState

_MASK64 = (1 << 64) - 1


def _mix(seed: int, step: int, purpose: int) -> int:
    """splitmix64 of (seed, step, purpose) -> a 63-bit generator seed."""
    z = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + purpose + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def step_generators(generator: torch.Generator, step: int, device: torch.device):
    """The step's two random streams, (augment, dropout), as fresh generators
    on ``device`` seeded from ``(generator.initial_seed(), step, purpose)``.
    ``generator`` itself is not advanced, so step ``n`` draws the same numbers
    whenever it is run with the same seed."""
    seed = generator.initial_seed()
    return tuple(torch.Generator(device=device).manual_seed(_mix(seed, step, purpose))
                 for purpose in (0, 1))


def make_train_step(
    model: torch.nn.Module, aug_cfg: AugmentConfig, *, device: str | torch.device = "cuda"
) -> Callable[[TrainState, torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor]:
    """Return ``train_step(state, images_u8, labels, generator) -> loss``.

    One full step, in place on ``state``: dual-view augmentation on the
    device, the dual-view forward in training mode, the five-term loss,
    backward, one optimizer update; ``state.step`` advances by one.  The model
    must already live on ``device`` (GPU unless ``device='cpu'``; raises
    without one).  ``images_u8``: uint8 ``[B, S, S, 3]``; ``labels``: ``[B]``
    integers; both are moved to the device if they are not there.

    Randomness: ``generator`` only carries the seed.  Each step derives its
    augmentation and dropout streams from ``(seed, state.step)`` (see
    :func:`step_generators`), so a step is reproducible and independent of
    what ran before it.  The returned loss is a detached scalar tensor on the
    device; the optimizer's finite check waits for the device once per step.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_precision()
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, training asked for {dev}")

    def train_step(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
        if state.model is not model:
            raise ValueError("the train state belongs to another model")
        model.train()
        aug_gen, drop_gen = step_generators(generator, state.step, model_dev)
        images = images_u8.to(model_dev, non_blocking=True)
        labels = labels.to(model_dev, non_blocking=True)
        with torch.no_grad():
            anchor, positive = dual_view_train_batch(images, aug_gen, aug_cfg)
        loss = model(anchor, positive, labels, generator=drop_gen)["loss"]
        model.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step
