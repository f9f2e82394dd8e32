"""The training and evaluation steps.

``make_train_step``: augment, forward, five-term loss, backward, update; the
counterpart of ``ego_moment_cle_vit_tpu/bench_core.py:28-57`` and, with
``metrics=True``, of the JAX trainer's step (``train/trainer.py:383-421``).
``make_eval_step``: the JAX trainer's eval step (``:423-434``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..data.augment import AugmentConfig, dual_view_eval_batch, dual_view_train_batch
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


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def _model_device(model: torch.nn.Module, device: str | torch.device) -> torch.device:
    """The model's device, which must be of ``device``'s kind; on the GPU
    full-fp32 products are pinned."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_precision()
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the step was asked for {dev}")
    return model_dev


def make_train_step(
    model: torch.nn.Module, aug_cfg: AugmentConfig, *, device: str | torch.device = "cuda",
    metrics: bool = False,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor]:
    """Return ``train_step(state, images_u8, labels, generator) -> loss``
    (``metrics=True``: -> ``{"loss", "accuracy", **loss_dict}``).

    One full step, in place on ``state``: dual-view augmentation on the
    device, the dual-view forward in training mode, the five-term loss,
    backward, one optimizer update; ``state.step`` advances by one.  The model
    must already live on ``device`` (GPU unless ``device='cpu'``; raises
    without one).  ``images_u8``: uint8 ``[B, S, S, 3]``; ``labels``: ``[B]``
    integers; both are moved to the device if they are not there.

    Randomness: ``generator`` only carries the seed.  Each step derives its
    augmentation and dropout streams from ``(seed, state.step)`` (see
    :func:`step_generators`), so a step is reproducible and independent of
    what ran before it.  The returned loss (and with ``metrics``, the batch
    accuracy of the main logits and every loss term) are detached scalar
    tensors on the device, not read by the host; the optimizer's finite check
    waits for the device once per step.
    """
    model_dev = _model_device(model, device)

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
        out = model(anchor, positive, labels, generator=drop_gen)
        loss = out["loss"]
        model.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        if not metrics:
            return loss.detach()
        return {"loss": loss.detach(), "accuracy": _accuracy(out["logits"].detach(), labels),
                **{k: v.detach() for k, v in out["loss_dict"].items()}}

    return train_step


def make_eval_step(
    model: torch.nn.Module, aug_cfg: AugmentConfig, *, device: str | torch.device = "cuda",
) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Return ``eval_step(images_u8, labels) -> {"loss", "accuracy"}``: the
    eval views (center crop, both views alike), the dual-view forward in eval
    mode under ``torch.inference_mode()`` as serving runs, the loss and the
    batch accuracy as scalar tensors on the device, not read by the host."""
    model_dev = _model_device(model, device)

    def eval_step(images_u8: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            images = images_u8.to(model_dev, non_blocking=True)
            labels = labels.to(model_dev, non_blocking=True)
            anchor, positive = dual_view_eval_batch(images, aug_cfg)
            out = model(anchor, positive, labels)
            return {"loss": out["loss"], "accuracy": _accuracy(out["logits"], labels)}

    return eval_step
