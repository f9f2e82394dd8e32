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
scalar back to the host per step.  Gradient accumulation and BatchNorm
statistics are not ported yet.

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
from torch import nn

from ..models.layers import Dense
from ..utils.device import resolve_device

Schedule = Callable[[int], float]


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, 'Modules to port', {item})")


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
        if int(tcfg.get("accumulation_steps", 1)) > 1:
            raise _not_ported("gradient accumulation (accumulation_steps > 1)",
                              "gradient accumulation")
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
        self.notfinite_count = 0    # consecutive non-finite steps
        self.total_notfinite = 0
        self.last_grad_norm: Optional[float] = None
        self.names: List[str] = []

    def init(self, named_params: Mapping[str, torch.Tensor],
             transposed: Iterable[str] = ()) -> "Optimizer":
        self.params = dict(named_params)
        self.names = list(self.params)
        transposed = set(transposed)
        self.dense: List[str] = []
        self.factored: List[str] = []
        self.master: Dict[str, torch.Tensor] = {}
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.v_row: Dict[str, torch.Tensor] = {}
        self.v_col: Dict[str, torch.Tensor] = {}
        self.ema: Dict[str, torch.Tensor] = {}
        self.factored_axes: Dict[str, tuple] = {}
        for name, p in self.params.items():
            if p.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"{name}: parameter dtype {p.dtype} not supported")
            if p.dtype == torch.bfloat16:
                self.master[name] = p.detach().float()
            big = self.factored_on and p.dim() == 2 and p.numel() >= self.factored_threshold
            if big:
                shape = tuple(p.t().shape) if name in transposed else tuple(p.shape)
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
                self.factored_axes[name] = (1 - d1, 1 - d0) if name in transposed else (d1, d0)
                self.v_row[name] = torch.zeros(shape[d1], dtype=torch.float32, device=p.device)
                self.v_col[name] = torch.zeros(shape[d0], dtype=torch.float32, device=p.device)
            else:
                self.dense.append(name)
                self.m[name] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                self.v[name] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return self

    _STATE_TENSORS = ("master", "m", "v", "v_row", "v_col", "ema")
    _STATE_COUNTS = ("count", "notfinite_count", "total_notfinite")

    def state_dict(self) -> Dict[str, Any]:
        """Everything ``step`` reads besides the parameters: the fp32 masters,
        both moments, the factored statistics, the bf16 EMA momentum and the
        update counts.  Tensors are the optimizer's own (``torch.save``
        copies them)."""
        return {"names": list(self.names),
                **{k: getattr(self, k) for k in self._STATE_COUNTS},
                **{k: dict(getattr(self, k)) for k in self._STATE_TENSORS}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a ``state_dict`` into this optimizer's state, in place and on
        its own devices and dtypes; it must come from an optimizer bound to
        the same leaves with the same options."""
        if list(state["names"]) != self.names:
            raise ValueError("the optimizer state belongs to other parameters")
        for k in self._STATE_TENSORS:
            mine, theirs = getattr(self, k), state[k]
            if sorted(mine) != sorted(theirs):
                raise ValueError(f"optimizer state {k!r} covers other leaves")
            for name, t in mine.items():
                if tuple(t.shape) != tuple(theirs[name].shape):
                    raise ValueError(f"optimizer state {k}[{name}]: shape "
                                     f"{tuple(theirs[name].shape)} != {tuple(t.shape)}")
                t.copy_(theirs[name])
        for k in self._STATE_COUNTS:
            setattr(self, k, int(state[k]))

    # the fp32 tensor an update runs on: the master of a bf16 leaf, else the leaf
    def _target(self, name: str) -> torch.Tensor:
        return self.master.get(name, self.params[name])

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        # per dtype, so each list keeps the multi-tensor fast path; a bf16 leaf
        # accumulates its sum in fp32 without an fp32 copy (a bf16 sum over
        # 269M elements would be garbage)
        norms = []
        for dt in (torch.float32, torch.bfloat16):
            same = [g for g in grads if g.dtype == dt]
            if same:
                norms += torch._foreach_norm(same, 2, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))

    @torch.no_grad()
    def step(self, grads: Optional[Mapping[str, torch.Tensor]] = None) -> bool:
        """One update.  Returns False when the step was skipped as non-finite."""
        if grads is None:
            grads = {n: p.grad for n, p in self.params.items()}
        missing = [n for n in self.names if grads.get(n) is None]
        if missing:
            raise ValueError(f"no gradient for {missing[:5]} ({len(missing)} leaves)")
        glist = [grads[n] for n in self.names]

        scale = 1.0
        if self.skip_nonfinite or self.max_norm is not None:
            g_norm = float(self._global_norm(glist))  # the step's one host read
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
            v_row = self.v_row[name].mul_(decay).add_(gsq.mean(dim=d0) + eps2, alpha=1 - decay)
            v_col = self.v_col[name].mul_(decay).add_(gsq.mean(dim=d1) + eps2, alpha=1 - decay)
            row_factor = (v_row / v_row.mean()).rsqrt()
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
    """Everything a step needs: the model, the optimizer state and the step
    count (which advances on skipped steps too)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: nn.Module, config: Dict[str, Any], steps_per_epoch: int, *,
                       device: str | torch.device = "cuda") -> TrainState:
    """Bind a fresh optimizer to ``model``'s parameters, on ``device``.

    Runs on the GPU unless ``device='cpu'``; raises without a GPU, and when
    the model does not live on ``device``.
    """
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the train state was asked for {dev}")
    if config.get("model", {}).get("norm", "layer") == "batch":
        raise _not_ported("batch_stats in the train state", "heads")
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    transposed = {f"{prefix}.weight" for prefix, mod in model.named_modules()
                  if isinstance(mod, Dense)}
    return TrainState(model, create_optimizer(config, steps_per_epoch).init(named, transposed))


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
    config.  Epoch checkpoints beyond the newest ``keep`` are removed."""
    path = _ckpt_dir(ckpt_dir)
    name = "best_model" if best else f"checkpoint_epoch_{epoch}"
    target = path / name
    if target.exists():
        shutil.rmtree(target)
    target.mkdir()
    torch.save(state.model.state_dict(), target / "model.pt")
    torch.save(state.optimizer.state_dict(), target / "optimizer.pt")
    meta = {"step": int(state.step), "epoch": int(epoch), "best_val_acc": float(best_val_acc),
            "config": config}
    (path / f"{name}.meta.json").write_text(json.dumps(meta, indent=2, default=str))

    if not best:
        for old in _epoch_checkpoints(path)[:-keep]:
            shutil.rmtree(path / f"checkpoint_epoch_{old}", ignore_errors=True)
            (path / f"checkpoint_epoch_{old}.meta.json").unlink(missing_ok=True)


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
