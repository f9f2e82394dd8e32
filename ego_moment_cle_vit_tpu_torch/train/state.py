"""Train state, learning-rate schedules and the optimizer, written out by hand.

Counterpart of ``ego_moment_cle_vit_tpu/train/state.py:39-347``, which builds
the same update from optax pieces:

* AdamW (bias-corrected moments, decoupled weight decay, lr from the
  schedule) for ordinary leaves;
* for 2-D leaves of ``factored_threshold`` (32M) elements or more, a factored
  second moment (Adafactor's row and column statistics with the time-dependent
  decay ``1 - t**-b2``, not a constant beta2, and ``eps**2`` added to the
  squared gradient), then an EMA momentum held in bf16 without debiasing,
  decoupled weight decay and the lr;
* fp32 masters for bf16-stored leaves (with ``model.bf16`` every Dense and
  conv weight is stored in bf16, not only the ``bf16_params`` projection): the
  update runs on the master and the parameter is set to ``bf16(new_master)``,
  so the rounding never accumulates.  The JAX package emits ``bf16(new_master)
  - param`` as a bf16 update, which lands on the same value to within one
  bf16 ulp;
* one fused global-norm clip (norm accumulated in fp32 whatever the leaf
  dtype) with non-finite containment: a step whose gradient norm is not
  finite changes nothing and is counted; after ``max_nonfinite_steps``
  consecutive ones the parameters are poisoned with NaN so training fails
  loudly.

Updates are in place, through ``torch._foreach_*`` over the ordinary leaves:
one launch per operation instead of one per leaf.  The finite check reads one
scalar back to the host per update.

Gradient accumulation (``accumulation_steps`` k > 1) is optax's
``MultiSteps(every_k_schedule=k)`` (optax 0.2.6): each micro-step folds its
gradient into a running mean kept in the leaf's own dtype (Welford's ``acc +
(g - acc) / (n + 1)``), and only the k-th runs the update above on that mean,
then resets the mean by multiplying it by zero, as optax does (so a
non-finite entry, once in it, stays: every later update is skipped, and the
parameters are poisoned on the first micro-step that finds
``max_nonfinite_steps`` skips behind it, as optax's update, run on every
micro-step and emitted times 0, poisons them there).  Without
``skip_nonfinite_updates`` a non-finite mean reaches the parameters at the
k-th micro-step; optax's 0 x NaN would set them to NaN a micro-step
earlier.  The schedule counts updates, not micro-steps.  BatchNorm running statistics are
buffers of the model, so the train state and its checkpoints carry them with
the model's ``state_dict``.

On a mesh (``parallel/``) the gradients reach ``step`` already summed over
the data axis, so the update is every data rank's alike.  A leaf whose fan-in
is sharded over the model axis holds this rank's block, and everything that
reads the whole leaf reads it across the model group: its squared norm is
added over the model group before the global norm (a replicated leaf counts
once), so every rank takes the same clip and skip decision; whether it is
factored follows its global shape and size; its factored row and column
statistics, and the mean of the row statistics, are reduced over the model
group where they run along the sharded axis.  ``state_dict`` gathers the
sharded leaves' state into the one-device format and ``load_state_dict``
takes this rank's block of it.

Checkpoints (JAX ``:390-495``) keep the JAX contract, ``best_model`` or
``checkpoint_epoch_{n}`` beside a ``{name}.meta.json`` sidecar with the step,
epoch, ``best_val_acc`` and config, the newest ``keep`` epoch checkpoints
kept; the tensors go through ``torch.save``: the model's ``state_dict`` and
the optimizer's (``Optimizer.state_dict``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import torch
import torch.distributed
from torch import nn

from ..models.layers import Dense
from ..parallel.collectives import all_reduce_sum
from ..parallel.sharding import block, gather_params, sharded_params, unshard
from ..utils.device import resolve_device
from ..utils.trace import span

Schedule = Callable[[int], float]


# ----------------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def create_learning_rate_schedule(config: Dict[str, Any], steps_per_epoch: int) -> Schedule:
    """``count -> lr`` from the config's ``training.{optimizer,scheduler}`` keys.

    'cosine': linear ``warmup_lr -> lr`` over ``warmup_epochs``, then cosine
    ``lr -> min_lr`` over the remaining epochs.  'constant': the same warmup,
    then ``lr``.
    """
    tcfg = config.get("training", {})
    opt = tcfg.get("optimizer", {})
    sched = tcfg.get("scheduler", {})
    lr = float(opt.get("lr", 3e-4))
    epochs = int(tcfg.get("epochs", 100))
    warmup_epochs = int(sched.get("warmup_epochs", 0))
    warmup_lr = float(sched.get("warmup_lr", 1e-6))
    min_lr = float(sched.get("min_lr", 1e-6))
    name = sched.get("name", "cosine")
    accum = max(int(tcfg.get("accumulation_steps", 1)), 1)
    warmup_steps = warmup_epochs * steps_per_epoch // accum
    total_steps = max(epochs * steps_per_epoch // accum, warmup_steps + 1, 1)

    if name == "cosine":
        init = warmup_lr if warmup_steps > 0 else lr
        alpha = 0.0 if lr == 0.0 else min_lr / lr
        return _join(_linear(init, lr, warmup_steps),
                     _cosine(lr, total_steps - warmup_steps, alpha), warmup_steps)
    if name == "constant":
        if warmup_steps > 0:
            return _join(_linear(warmup_lr, lr, warmup_steps), lambda count: lr, warmup_steps)
        return lambda count: lr
    raise ValueError(f"Unknown scheduler: {name}")


# ----------------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------------


def _factored_dims(shape) -> Optional[tuple]:
    """The two largest axes (second largest, largest) of a leaf that gets
    factored statistics, or None when no two axes reach 128."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # stable, like numpy's argsort
    if shape[order[-2]] < 128:
        return None
    return order[-2], order[-1]


class Optimizer:
    """The update described in the module docstring, over named leaves.

    ``init(named_params, transposed=...)`` allocates the state beside the
    parameters; ``step()`` reads each parameter's ``.grad`` (or a mapping of
    gradients), scales the gradients in place by the clip factor and updates
    parameters and state in place.  ``transposed`` names the 2-D leaves stored
    as the transpose of their flax layout (the port's Dense weights are
    ``[out, in]``); the factored statistics follow the flax layout.
    """

    def __init__(self, config: Dict[str, Any], steps_per_epoch: int):
        tcfg = config.get("training", {})
        opt = tcfg.get("optimizer", {})
        self.accumulation_steps = max(int(tcfg.get("accumulation_steps", 1)), 1)
        betas = opt.get("betas", [0.9, 0.999])
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(opt.get("eps", 1e-8))
        self.weight_decay = float(opt.get("weight_decay", 0.05))
        self.factored_threshold = int(opt.get("factored_threshold", 32_000_000))
        self.factored_on = bool(opt.get("factored_large_leaves", True))
        self.schedule = create_learning_rate_schedule(config, steps_per_epoch)
        grad_clip = float(tcfg.get("grad_clip", 1.0))
        self.max_norm = grad_clip if grad_clip > 0 else None
        self.skip_nonfinite = bool(tcfg.get("skip_nonfinite_updates", True))
        self.max_nonfinite_steps = int(tcfg.get("max_nonfinite_steps", 10))
        self.count = 0              # finite updates applied so far
        self.mini_step = 0          # micro-gradients in the running mean
        self.notfinite_count = 0    # consecutive non-finite steps
        self.total_notfinite = 0
        self.last_grad_norm: Optional[float] = None
        self.names: List[str] = []

    def init(self, named_params: Mapping[str, torch.Tensor],
             transposed: Iterable[str] = (), unfactored: Iterable[str] = (),
             sharded: Optional[Mapping[str, int]] = None, mesh=None) -> "Optimizer":
        """``unfactored`` names 2-D leaves whose flax leaf is not 2-D (a
        DenseGeneral kernel), which the JAX labels never factor.  ``sharded``
        ({name: dimension}) names the leaves that hold this rank's block of a
        dimension split over ``mesh``'s model axis."""
        self.mesh = mesh
        self.sharded = dict(sharded or {})
        self.params = dict(named_params)
        self.names = list(self.params)
        transposed = set(transposed)
        unfactored = set(unfactored)
        self.dense: List[str] = []
        self.factored: List[str] = []
        self.master: Dict[str, torch.Tensor] = {}
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.v_row: Dict[str, torch.Tensor] = {}
        self.v_col: Dict[str, torch.Tensor] = {}
        self.ema: Dict[str, torch.Tensor] = {}
        self.factored_axes: Dict[str, tuple] = {}
        self.acc: Dict[str, torch.Tensor] = {}
        for name, p in self.params.items():
            if self.accumulation_steps > 1:
                self.acc[name] = torch.zeros_like(p, memory_format=torch.contiguous_format)
            if p.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"{name}: parameter dtype {p.dtype} not supported")
            if p.dtype == torch.bfloat16:
                self.master[name] = p.detach().float()
            gshape = list(p.shape)  # the leaf's global shape
            if name in self.sharded:
                gshape[self.sharded[name]] *= mesh.model
            big = (self.factored_on and p.dim() == 2
                   and math.prod(gshape) >= self.factored_threshold and name not in unfactored)
            if big:
                shape = tuple(reversed(gshape)) if name in transposed else tuple(gshape)
                dims = _factored_dims(shape)
                self.factored.append(name)
                self.ema[name] = torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                if dims is None:
                    # an axis under 128: the same chain with a full second moment
                    self.factored_axes[name] = None
                    self.v[name] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    continue
                d1, d0 = dims
                # the leaf's own axes that carry the flax layout's (d1, d0)
                a1, a0 = (1 - d1, 1 - d0) if name in transposed else (d1, d0)
                self.factored_axes[name] = (a1, a0)
                self.v_row[name] = torch.zeros(p.shape[a1], dtype=torch.float32, device=p.device)
                self.v_col[name] = torch.zeros(p.shape[a0], dtype=torch.float32, device=p.device)
            else:
                self.dense.append(name)
                self.m[name] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                self.v[name] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return self

    _STATE_TENSORS = ("master", "m", "v", "v_row", "v_col", "ema", "acc")
    _STATE_COUNTS = ("count", "mini_step", "notfinite_count", "total_notfinite")

    def _state_shard_dim(self, kind: str, name: str) -> Optional[int]:
        """The dimension of state tensor ``kind[name]`` split over the model
        axis, or None."""
        dim = self.sharded.get(name)
        if dim is None:
            return None
        if kind in ("v_row", "v_col"):
            axes = self.factored_axes.get(name)
            # v_row runs along leaf axis a1, v_col along a0
            return 0 if axes is not None and axes[kind == "v_col"] == dim else None
        return dim

    def state_dict(self) -> Dict[str, Any]:
        """Everything ``step`` reads besides the parameters: the fp32 masters,
        both moments, the factored statistics, the bf16 EMA momentum, the
        accumulated mean gradient and the counts (updates, micro-steps into
        the mean, non-finite steps).  Tensors are the optimizer's own
        (``torch.save`` copies them).  On a mesh with sharded leaves their
        state is gathered into the one-device format: every rank must call
        it."""
        tensors = {}
        for k in self._STATE_TENSORS:
            tensors[k] = {}
            for name, t in getattr(self, k).items():
                dim = self._state_shard_dim(k, name)
                tensors[k][name] = t if dim is None else unshard(t, dim, self.mesh)
        return {"names": list(self.names),
                **{k: getattr(self, k) for k in self._STATE_COUNTS}, **tensors}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a ``state_dict`` into this optimizer's state, in place and on
        its own devices and dtypes; it must come from an optimizer bound to
        the same leaves with the same options.  A sharded leaf takes this
        rank's block of the one-device state."""
        if list(state["names"]) != self.names:
            raise ValueError("the optimizer state belongs to other parameters")
        for k in self._STATE_TENSORS:
            mine, theirs = getattr(self, k), state.get(k, {})
            if sorted(mine) != sorted(theirs):
                raise ValueError(f"optimizer state {k!r} covers other leaves")
            for name, t in mine.items():
                src = theirs[name]
                dim = self._state_shard_dim(k, name)
                if dim is not None:
                    src = block(src, dim, self.mesh)
                if tuple(t.shape) != tuple(src.shape):
                    raise ValueError(f"optimizer state {k}[{name}]: shape "
                                     f"{tuple(src.shape)} != {tuple(t.shape)}")
                t.copy_(src)
        for k in self._STATE_COUNTS:
            setattr(self, k, int(state.get(k, 0)))

    # the fp32 tensor an update runs on: the master of a bf16 leaf, else the leaf
    def _target(self, name: str) -> torch.Tensor:
        return self.master.get(name, self.params[name])

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of ``grads`` (one per leaf, in ``self.names`` order)."""
        # per dtype, so each list keeps the multi-tensor fast path; a bf16 leaf
        # accumulates its sum in fp32 without an fp32 copy (a bf16 sum over
        # 269M elements would be garbage)
        norms, names = [], []
        for dt in (torch.float32, torch.bfloat16):
            idx = [i for i, g in enumerate(grads) if g.dtype == dt]
            if idx:
                norms += torch._foreach_norm([grads[i] for i in idx], 2, dtype=torch.float32)
                names += [self.names[i] for i in idx]
        if self.sharded:
            # a sharded leaf's norm from its blocks' squares, summed over the
            # model group in fp32: every model rank gets the same norm
            at = [j for j, n in enumerate(names) if n in self.sharded]
            whole = all_reduce_sum(torch.stack([norms[j] for j in at]).square(),
                                   self.mesh.model_group).sqrt()
            for j, v in zip(at, whole):
                norms[j] = v
        return torch.linalg.vector_norm(torch.stack(norms))

    @torch.no_grad()
    def step(self, grads: Optional[Mapping[str, torch.Tensor]] = None) -> bool:
        """One micro-step: with accumulation, fold the gradients into the
        running mean and, on every k-th call, update from the mean; else one
        update.  Returns False when an update was skipped as non-finite."""
        if grads is None:
            grads = {n: p.grad for n, p in self.params.items()}
        missing = [n for n in self.names if grads.get(n) is None]
        if missing:
            raise ValueError(f"no gradient for {missing[:5]} ({len(missing)} leaves)")
        if self.accumulation_steps == 1:
            return self._update(grads)
        acc = [self.acc[n] for n in self.names]
        delta = torch._foreach_sub([grads[n] for n in self.names], acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(acc, delta)
        del delta
        if self.mini_step < self.accumulation_steps - 1:
            self.mini_step += 1
            if self.skip_nonfinite and self.notfinite_count >= self.max_nonfinite_steps:
                # optax runs the inner transform on every micro-step and emits
                # 0 x its update: once its next skip would poison, that NaN
                # leaks through.  Read only in that state, as rare as it is.
                acc_norm = self._global_norm(acc)
                with span("train.host_read"):
                    acc_norm = float(acc_norm)
                if not math.isfinite(acc_norm):
                    for p in self.params.values():
                        p.fill_(float("nan"))
            return True
        self.mini_step = 0
        applied = self._update(dict(self.acc))
        torch._foreach_mul_(acc, 0.0)  # optax's reset: a non-finite entry survives it
        return applied

    def _update(self, grads: Mapping[str, torch.Tensor]) -> bool:
        """One update from ``grads`` (scaled in place by the clip factor)."""
        glist = [grads[n] for n in self.names]

        scale = 1.0
        if self.skip_nonfinite or self.max_norm is not None:
            g_norm = self._global_norm(glist)
            with span("train.host_read"):
                g_norm = float(g_norm)  # the step's one host read
            self.last_grad_norm = g_norm
            if self.skip_nonfinite and not math.isfinite(g_norm):
                self.notfinite_count += 1
                self.total_notfinite += 1
                if self.notfinite_count > self.max_nonfinite_steps:
                    for p in self.params.values():
                        p.fill_(float("nan"))
                return False
            if self.max_norm is not None:
                scale = min(self.max_norm / max(g_norm, 1e-16), 1.0)
        self.notfinite_count = 0
        if scale != 1.0:
            # one list per dtype keeps the multi-tensor fast path
            for dt in (torch.float32, torch.bfloat16):
                same = [g for g in glist if g.dtype == dt]
                if same:
                    torch._foreach_mul_(same, scale)

        lr = self.schedule(self.count)
        t = self.count + 1
        self._dense_step(grads, lr, t)
        for name in self.factored:
            self._factored_step(name, grads[name], lr, t)
        if self.master:
            # each bf16 leaf lands on bf16(new master): one multi-tensor cast
            torch._foreach_copy_([self.params[n] for n in self.master],
                                 list(self.master.values()))
        self.count = t
        return True

    def _dense_step(self, grads: Mapping[str, torch.Tensor], lr: float, t: int) -> None:
        if not self.dense:
            return
        g = [grads[n] if grads[n].dtype == torch.float32 else grads[n].float()
             for n in self.dense]
        target = [self._target(n) for n in self.dense]
        m = [self.m[n] for n in self.dense]
        v = [self.v[n] for n in self.dense]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, math.sqrt(bc2))
        torch._foreach_add_(denom, self.eps)
        # p <- p - lr (m_hat / denom + wd p)
        torch._foreach_mul_(target, 1 - lr * self.weight_decay)
        torch._foreach_addcdiv_(target, m, denom, value=-lr / bc1)

    def _mean(self, x: torch.Tensor, dim: int, shard: Optional[int]) -> torch.Tensor:
        """The mean of ``x`` over ``dim``, across the model group where ``dim``
        is the one split over it (``shard``)."""
        if dim != shard:
            return x.mean(dim=dim)
        total = all_reduce_sum(x.sum(dim=dim), self.mesh.model_group)
        return total / (x.shape[dim] * self.mesh.model)

    def _factored_step(self, name: str, grad: torch.Tensor, lr: float, t: int) -> None:
        target = self._target(name)
        g = grad.float() if grad.dtype != torch.float32 else grad.clone()
        decay = 1.0 - float(t) ** (-self.b2)
        eps2 = self.eps ** 2
        gsq = g.square()
        if self.factored_axes[name] is None:
            v = self.v[name].mul_(decay).add_(gsq.add_(eps2), alpha=1 - decay)
            g.mul_(v.rsqrt())
        else:
            d1, d0 = self.factored_axes[name]
            shard = self.sharded.get(name)
            v_row = self.v_row[name].mul_(decay).add_(self._mean(gsq, d0, shard) + eps2,
                                                      alpha=1 - decay)
            v_col = self.v_col[name].mul_(decay).add_(self._mean(gsq, d1, shard) + eps2,
                                                      alpha=1 - decay)
            row_mean = v_row.mean() if shard != d1 else self._mean(v_row, 0, 0)
            row_factor = (v_row / row_mean).rsqrt()
            col_factor = v_col.rsqrt()
            g.mul_(row_factor.unsqueeze(d0)).mul_(col_factor.unsqueeze(d1))
        del gsq
        # EMA momentum held in bf16, no debias: the update is the fp32 blend
        ema = self.ema[name]
        g.mul_(1 - self.b1).add_(ema.float(), alpha=self.b1)
        ema.copy_(g)
        g.add_(target, alpha=self.weight_decay)
        target.add_(g, alpha=-lr)


def create_optimizer(config: Dict[str, Any], steps_per_epoch: int) -> Optimizer:
    """The optimizer of the config's ``training`` section, not yet bound to
    parameters (``Optimizer.init`` does that)."""
    return Optimizer(config, steps_per_epoch)


@dataclasses.dataclass
class TrainState:
    """Everything a step needs: the model (with its BatchNorm running
    statistics, buffers of the model), the optimizer state and the step count
    (micro-steps: it advances on skipped steps too); on a mesh, the mesh."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    mesh: Any = None


def create_train_state(model: nn.Module, config: Dict[str, Any], steps_per_epoch: int, *,
                       device: str | torch.device = "cuda", mesh=None) -> TrainState:
    """Bind a fresh optimizer to ``model``'s parameters, on ``device``.

    Runs on the GPU unless ``device='cpu'``; raises without a GPU, and when
    the model does not live on ``device``.  On a mesh, call it after
    ``parallel.shard_params``: the optimizer reads which leaves are sharded.
    """
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the train state was asked for {dev}")
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    dense = {f"{prefix}.weight": mod for prefix, mod in model.named_modules()
             if isinstance(mod, Dense)}
    unfactored = {n for n, mod in dense.items() if mod.flax_kernel_shape is not None}
    return TrainState(model, create_optimizer(config, steps_per_epoch).init(
        named, set(dense), unfactored, sharded_params(model), mesh), mesh=mesh)


def _ckpt_dir(path: str) -> Path:
    p = Path(path).resolve()
    p.mkdir(parents=True, exist_ok=True)
    return p


def _epoch_checkpoints(path: Path) -> List[int]:
    return sorted(int(p.name.rsplit("_", 1)[1]) for p in path.glob("checkpoint_epoch_*")
                  if p.is_dir() and p.name.rsplit("_", 1)[1].isdigit())


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, best_val_acc: float,
                    config: Dict[str, Any], keep: int = 5, best: bool = False) -> None:
    """Write ``best_model`` (``best=True``) or ``checkpoint_epoch_{epoch}``
    under ``ckpt_dir``: ``model.pt`` (the model's ``state_dict``) and
    ``optimizer.pt`` (the optimizer's) in a directory of that name, and
    ``{name}.meta.json`` beside it with the step, epoch, ``best_val_acc`` and
    config.  Epoch checkpoints beyond the newest ``keep`` are removed.

    On a mesh every rank must call it: the sharded leaves and their state are
    gathered into the one-device format, rank 0 alone writes, and every rank
    leaves once the files are there."""
    mesh = state.mesh
    if mesh is None:
        model_state = state.model.state_dict()
    else:
        model_state = gather_params(state.model, mesh)
    opt_state = state.optimizer.state_dict()
    if mesh is None or mesh.rank == 0:
        path = _ckpt_dir(ckpt_dir)
        name = "best_model" if best else f"checkpoint_epoch_{epoch}"
        target = path / name
        if target.exists():
            shutil.rmtree(target)
        target.mkdir()
        torch.save(model_state, target / "model.pt")
        torch.save(opt_state, target / "optimizer.pt")
        meta = {"step": int(state.step), "epoch": int(epoch),
                "best_val_acc": float(best_val_acc), "config": config}
        (path / f"{name}.meta.json").write_text(json.dumps(meta, indent=2, default=str))

        if not best:
            for old in _epoch_checkpoints(path)[:-keep]:
                shutil.rmtree(path / f"checkpoint_epoch_{old}", ignore_errors=True)
                (path / f"checkpoint_epoch_{old}.meta.json").unlink(missing_ok=True)
    if mesh is not None:
        torch.distributed.barrier()


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The newest epoch checkpoint's epoch under ``ckpt_dir``, or None."""
    path = Path(ckpt_dir)
    if not path.exists():
        return None
    epochs = _epoch_checkpoints(path)
    return epochs[-1] if epochs else None


def restore_checkpoint(ckpt_path: str, *, device: str | torch.device = "cuda",
                       optimizer: bool = True) -> Dict[str, Any]:
    """Load a checkpoint written by :func:`save_checkpoint` onto ``device``
    (GPU unless ``device='cpu'``; raises without one), whatever device wrote
    it.

    Returns ``{"model": state_dict, "optimizer": state_dict or None}`` plus
    the sidecar's step, epoch, best_val_acc and config.  ``optimizer=False``
    skips the optimizer's state (evaluation and serving need only the
    model's)."""
    dev = resolve_device(device)
    path = Path(ckpt_path).resolve()
    if not (path / "model.pt").exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    bundle: Dict[str, Any] = {
        "model": torch.load(path / "model.pt", map_location=dev, weights_only=True),
        "optimizer": (torch.load(path / "optimizer.pt", map_location=dev, weights_only=True)
                      if optimizer else None),
    }
    meta_file = path.parent / f"{path.name}.meta.json"
    if meta_file.exists():
        bundle.update(json.loads(meta_file.read_text()))
    return bundle
