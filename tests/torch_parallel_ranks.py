"""The ranks of ``tests/test_torch_parallel.py``'s CPU mesh runs.

Each rank is a process started with ``spawn``; it imports only the port
(never JAX), runs one intra-op thread, joins a gloo group through a
``file://`` store, runs its tasks on the inputs the test wrote, and saves
what it found to ``rank{r}.npz``.  Every group has a timeout, so a rank that
fails fails its peers instead of hanging them.
"""

from __future__ import annotations

import contextlib
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ego_moment_cle_vit_tpu_torch import create_model, create_train_state, make_train_step
from ego_moment_cle_vit_tpu_torch.data import AugmentConfig
from ego_moment_cle_vit_tpu_torch.models import ego_moment_clevit, layers
from ego_moment_cle_vit_tpu_torch.parallel import (
    collectives,
    create_mesh,
    gather_batch,
    gather_params,
    kernel_mesh,
    load_params,
    shard_params,
    sharded_params,
)
from ego_moment_cle_vit_tpu_torch.parallel.sharding import block, unshard
from ego_moment_cle_vit_tpu_torch.train import Trainer, create_optimizer
from ego_moment_cle_vit_tpu_torch.train import state as tstate
from ego_moment_cle_vit_tpu_torch.train import step as tstep

TIMEOUT = timedelta(seconds=180)


def _mesh(data: int, model: int):
    return create_mesh(data, model, ["cpu"] * dist.get_world_size(), timeout=TIMEOUT)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _model(inputs: dict, mesh):
    model = create_model(inputs["config"], num_classes=inputs["num_classes"], device="cpu")
    model.load_state_dict(inputs["state"])
    if mesh is not None:
        shard_params(model, mesh)
    return model.train()


def _whole_grads(model, mesh) -> dict:
    sharded = sharded_params(model)
    return {n: unshard(p.grad, sharded[n], mesh) if n in sharded else p.grad
            for n, p in model.named_parameters()}


def _loss_and_grads(inputs: dict, mesh, generator_seed=None) -> dict:
    """The mesh's loss, loss terms and whole gradients on the global views."""
    model = _model(inputs, mesh)
    b = len(inputs["labels"]) // mesh.data
    lo = mesh.data_index * b
    x = [torch.from_numpy(inputs[k][lo:lo + b]) for k in ("anchor", "positive", "labels")]
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    with kernel_mesh(mesh, b):
        out = model(*x, generator=gen)
        out["loss"].backward()
    collectives.sum_gradients_over_data(model.parameters(), mesh)
    res = {"loss": _np(out["loss"]), **{f"term/{k}": _np(v) for k, v in out["loss_dict"].items()}}
    res.update({f"grad/{n}": _np(g) for n, g in _whole_grads(model, mesh).items()})
    res.update({f"param/{n}": _np(t) for n, t in gather_params(model, mesh).items()})
    return res


def _one_device(inputs: dict, generator_seed=None) -> dict:
    model = _model(inputs, None)
    x = [torch.from_numpy(inputs[k]) for k in ("anchor", "positive", "labels")]
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    out = model(*x, generator=gen)
    out["loss"].backward()
    return {"loss": _np(out["loss"]),
            **{f"grad/{n}": _np(p.grad) for n, p in model.named_parameters()}}


def _prefixed(tag: str, res: dict) -> dict:
    return {f"{tag}/{k}": v for k, v in res.items()}


# -- tasks --------------------------------------------------------------------


def grads(inputs_dir: Path, data: int, model: int) -> dict:
    """Loss and gradients at (data, model) on the views, dropout off."""
    inputs = torch.load(inputs_dir / "micro.pt", weights_only=False)
    return _prefixed(f"grads_{data}x{model}", _loss_and_grads(inputs, _mesh(data, model)))


def controls(inputs_dir: Path) -> dict:
    """Two faults the comparison must catch: the roll's negative taken on the
    rank's own rows, at (2, 1); the model group's sum of a row-parallel
    product's input gradient dropped, at (1, 2)."""
    inputs = torch.load(inputs_dir / "micro.pt", weights_only=False)
    out = {}
    mesh = _mesh(2, 1)
    roll = ego_moment_clevit.roll_negative_triplet_loss
    rows = slice(mesh.data_index * 4, (mesh.data_index + 1) * 4)

    def local_roll(anchor, positive, margin):
        return roll(anchor[rows], positive[rows], margin=margin)

    with _patched(ego_moment_clevit, "roll_negative_triplet_loss", local_roll):
        out.update(_prefixed("local_roll", _loss_and_grads(inputs, mesh)))
    with _patched(layers, "copy_to_model", lambda x, mesh: x):
        out.update(_prefixed("no_dx_reduce", _loss_and_grads(inputs, _mesh(1, 2))))
    return out


def dropout(inputs_dir: Path, data: int, model: int) -> dict:
    """Dropout on: the mesh against the one-device forward on one generator."""
    inputs = torch.load(inputs_dir / "dropout.pt", weights_only=False)
    out = _prefixed("dropout", _loss_and_grads(inputs, _mesh(data, model), generator_seed=5))
    out.update(_prefixed("dropout_one", _one_device(inputs, generator_seed=5)))
    return out


def gradcheck(inputs_dir: Path) -> dict:
    """gradcheck of the four collectives in fp64, each composed as the model
    composes it, on an input every rank holds whole (its gradient is summed
    over the group, as a replicated parameter's is)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 4, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(3, 4, dtype=torch.float64, generator=g, requires_grad=True)
    ok = {}
    tp = _mesh(1, 2)  # the model group is the world

    def row_parallel(x, w):  # a row-parallel product: copy, block product, reduce
        n = x.shape[1] // tp.model
        lo = tp.model_index * n
        xb = collectives.copy_to_model(x, tp)[:, lo:lo + n]
        wb = collectives.copy_to_model(w, tp)[:, lo:lo + n]
        return collectives.reduce_from_model(xb @ wb.T, tp)

    ok["copy_to_model, reduce_from_model"] = torch.autograd.gradcheck(row_parallel, (x, w))

    dp = _mesh(2, 1)  # the data group is the world

    def replicated(t):  # identity forward, gradient summed over the data group
        return collectives._CopyToModel.apply(t, dp.data_group)

    def rows(t):
        b = t.shape[0] // dp.data
        return replicated(t)[dp.data_index * b:(dp.data_index + 1) * b]

    def gathered(x):
        return gather_batch(rows(x) * 2.0, dp)

    def centered(x):  # BatchNorm's use: global statistics from summed rows
        xr = rows(x)
        mean = collectives.sum_over_data(xr.sum(dim=0), dp) / x.shape[0]
        return gather_batch((xr - mean) ** 2, dp)

    ok["gather_batch"] = torch.autograd.gradcheck(gathered, (x,))
    ok["sum_over_data"] = torch.autograd.gradcheck(centered, (x,))
    return {f"gradcheck/{k}": np.asarray(v) for k, v in ok.items()}


def optimizer(inputs_dir: Path) -> dict:
    """The optimizer on (1, 2) against the one-device optimizer on the whole
    leaves: factored statistics along and across the sharded fan-in, a bf16
    leaf with its fp32 master, the clip, and a non-finite step found on one
    rank's block only."""
    mesh = _mesh(1, 2)
    cfg = {"training": {"optimizer": {"lr": 1e-2, "factored_threshold": 10_000},
                        "scheduler": {"warmup_epochs": 0}, "epochs": 1, "grad_clip": 1.0}}
    g = torch.Generator().manual_seed(3)
    shapes = {"wide_in.weight": ((128, 512), torch.float32),    # fan-in the larger axis
              "wide_out.weight": ((512, 256), torch.float32),   # fan-in the smaller
              "half.weight": ((160, 256), torch.bfloat16),      # bf16 with a master
              "small.weight": ((64, 16), torch.float32),        # unfactored, sharded
              "bias": ((512,), torch.float32)}                  # replicated
    whole = {n: torch.randn(s, generator=g).to(dt) for n, (s, dt) in shapes.items()}
    sharded = {n: 1 for n in whole if n.endswith("weight")}
    local = {n: block(t, 1, mesh) if n in sharded else t.clone() for n, t in whole.items()}
    transposed = set(sharded)
    one = create_optimizer(cfg, 10).init(dict(whole), transposed)
    mine = create_optimizer(cfg, 10).init(dict(local), transposed, sharded=sharded, mesh=mesh)
    applied = []
    for i in range(4):
        grads = {n: torch.randn(t.shape, generator=g).to(t.dtype) * (3.0 if i else 0.01)
                 for n, t in whole.items()}
        if i == 2:
            grads["wide_in.weight"][0, -1] = float("nan")  # in model rank 1's block only
        applied.append((one.step({n: v.clone() for n, v in grads.items()}),
                        mine.step({n: block(v, 1, mesh) if n in sharded else v.clone()
                                   for n, v in grads.items()})))
    out = {"optimizer/applied": np.asarray(applied),
           "optimizer/counts": np.asarray([[one.count, one.total_notfinite],
                                           [mine.count, mine.total_notfinite]]),
           "optimizer/factored": np.asarray([sorted(one.factored) == sorted(mine.factored),
                                             len(mine.factored)])}
    for n, t in local.items():
        got = unshard(t, 1, mesh) if n in sharded else t
        out[f"optimizer/param/{n}"] = _np(got)
        out[f"optimizer/param_one/{n}"] = _np(whole[n])
    state = mine.state_dict()  # the one-device format
    ref = one.state_dict()
    out["optimizer/state_equal_shapes"] = np.asarray(all(
        tuple(state[k][n].shape) == tuple(ref[k][n].shape)
        for k in tstate.Optimizer._STATE_TENSORS for n in ref[k]))
    for k in ("v_row", "v_col", "ema", "master", "m", "v"):
        for n, t in ref[k].items():
            out[f"optimizer/state/{k}/{n}"] = _np(state[k][n])
            out[f"optimizer/state_one/{k}/{n}"] = _np(t)
    return out


def bn_steps(inputs_dir: Path, data: int, model: int) -> dict:
    """Three micro-steps of ``make_train_step`` on the mesh (BatchNorm heads, a
    factored sharded ``second_proj``, accumulation 2) on fixed views, then a
    checkpoint written from the mesh and restored onto it."""
    inputs = torch.load(inputs_dir / "swin_bn.pt", weights_only=False)
    mesh = _mesh(data, model)
    model_ = _model(inputs, mesh)
    state = create_train_state(model_, inputs["config"], 100, device="cpu", mesh=mesh)
    views = inputs["views"]
    b = len(views[0][2]) // mesh.data
    lo = mesh.data_index * b
    fed = iter(views)

    def fixed_views(images, generator, aug_cfg, rows=None):
        anchor, positive, _ = next(fed)
        return (torch.from_numpy(anchor[rows[0]:rows[0] + b]),
                torch.from_numpy(positive[rows[0]:rows[0] + b]))

    step = make_train_step(model_, AugmentConfig(56, 64), device="cpu", mesh=mesh)
    u8 = torch.zeros(b, 64, 64, 3, dtype=torch.uint8)
    losses = []
    with _patched(tstep, "dual_view_train_batch", fixed_views):
        for _, _, labels in views:
            losses.append(_np(step(state, u8, torch.from_numpy(labels[lo:lo + b]),
                                   torch.Generator().manual_seed(0))))
    out = {"bn/loss": np.asarray(losses),
           "bn/factored": np.asarray(sorted(state.optimizer.factored)),
           "bn/counts": np.asarray([state.step, state.optimizer.count,
                                    state.optimizer.total_notfinite])}
    out.update({f"bn/local/{n}": _np(t) for n, t in model_.state_dict().items()})
    whole = gather_params(model_, mesh)
    out.update({f"bn/whole/{n}": _np(t) for n, t in whole.items()})
    ckpt = inputs_dir / "bn_ckpt"
    tstate.save_checkpoint(str(ckpt), state, 0, 0.5, inputs["config"])
    opt_whole = state.optimizer.state_dict()
    if mesh.rank == 0:
        torch.save({"model": whole, "optimizer": opt_whole}, inputs_dir / "bn_gathered.pt")
    # restored onto the same mesh: every local tensor back bit for bit
    fresh = _model(inputs, mesh)
    fresh_state = create_train_state(fresh, inputs["config"], 100, device="cpu", mesh=mesh)
    bundle = tstate.restore_checkpoint(str(ckpt / "checkpoint_epoch_0"), device="cpu")
    load_params(fresh, bundle["model"], mesh)
    fresh_state.optimizer.load_state_dict(bundle["optimizer"])
    same = all(torch.equal(a, fresh.state_dict()[n]) for n, a in model_.state_dict().items())
    for k in tstate.Optimizer._STATE_TENSORS:
        theirs = getattr(fresh_state.optimizer, k)
        same &= all(torch.equal(t, theirs[n]) for n, t in getattr(state.optimizer, k).items())
    out["bn/restored_on_mesh"] = np.asarray(same)
    return out


def trainer(inputs_dir: Path, data: int, model: int) -> dict:
    """The smoke-config Trainer on (data, model), augmentation and dropout on."""
    cfg = torch.load(inputs_dir / f"trainer_{data}x{model}.pt", weights_only=False)
    t = Trainer(cfg, device="cpu")
    assert (t.mesh.data, t.mesh.model) == (data, model)
    t.setup_data()
    t.setup_model()
    res = t.train()
    out = {f"{k}": np.asarray(v) for k, v in res["history"].items()}
    out["best_val_acc"] = np.asarray(res["best_val_acc"])
    out.update({f"param/{n}": _np(v) for n, v in gather_params(t.model, t.mesh).items()})
    return _prefixed(f"trainer_{data}x{model}", out)


def layout(inputs_dir: Path, data: int, model: int) -> dict:
    """The ranks of this rank's data and model groups."""
    mesh = _mesh(data, model)
    return {f"layout_{data}x{model}/data": np.asarray(dist.get_process_group_ranks(mesh.data_group)),
            f"layout_{data}x{model}/model": np.asarray(
                dist.get_process_group_ranks(mesh.model_group)),
            f"layout_{data}x{model}/index": np.asarray([mesh.data_index, mesh.model_index])}


TASKS = {"layout": layout, "grads": grads, "controls": controls, "dropout": dropout, "gradcheck": gradcheck,
         "optimizer": optimizer, "bn_steps": bn_steps, "trainer": trainer}


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def run(rank: int, world: int, store: str, inputs_dir: str, tasks: list) -> None:
    """One rank: its tasks in order, each ``(name, *args)``; the results to
    ``inputs_dir/rank{rank}.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = {}
        inputs = Path(inputs_dir)
        for name, *args in tasks:
            out.update(TASKS[name](inputs, *args))
        np.savez(inputs / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
