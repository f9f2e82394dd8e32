"""Named spans at the port's layer boundaries, on the profiler's clock.

``span(name)`` opens ``torch.autograd.profiler.record_function("emct." +
name)`` while a ``torch.profiler`` is running in the calling thread (the
autograd engine's threads inherit it from the thread that called
``backward``), and does nothing else otherwise: one check of the profiler's
flag, under a microsecond, where an unguarded ``record_function`` costs
about 12 us on an H100 host.  The ranges land in the profiler's trace as
``user_annotation`` events beside the device's CUDA activity, so every
device operation and every idle gap can be laid against the span the host
was in when it launched it.

There is no switch of its own: a span is recorded exactly when a profiler
is, as under the trainer's ``experiment.profile_steps`` (``cli/train.py
--profile``).  Names carry no shapes (``record_function``'s argument string
does not reach the exported trace).  The names:

* ``train.step`` (the whole ``train_step`` call), ``train.augment``,
  ``train.forward``, ``train.loss`` (the model's loss terms, wherever its
  forward is given labels), ``train.backward`` (``zero_grad`` and
  ``loss.backward()``; under block remat the recomputed forward too),
  ``train.grad_sum`` (on a mesh), ``train.update`` (``optimizer.step``),
  ``train.host_read`` (the optimizer's read of the gradient norm);
* ``serve.infer`` (the whole ``infer`` call), ``serve.preprocess`` (the
  input's move to the device and the eval views);
* ``backbone``, ``gpf``, ``moment_head``, ``classifier``: the model's layers;
* ``rope``, ``swiglu``: inside every EVA block (``models/eva.py``), the
  rotation of q and k with their write, beside v, into the attention
  kernels' layout, and the whole SwiGLU MLP; ``swiglu`` also around the
  packed SwiGLU MLP of every DINOv2 block (``models/vit.py``);
* ``layer_scale``: each of a DINOv2 block's two residual updates
  ``x + gamma * branch`` (``models/vit.py``), where LayerScale is on;
* ``kernel.<wrapper>``: each hand-written kernel's launch, one range per
  ``<wrapper>.launches`` count;
* ``data.wait``: the consumer's wait on a background loader's queue.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "emct."
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled  # bound once: the off path is this call


def span(name: str):
    """A context manager: the range ``"emct." + name`` while a profiler is
    running, else nothing."""
    if not _profiler_enabled():
        return _OFF
    return torch.autograd.profiler.record_function(PREFIX + name)
