"""The port's data x model parallelism against the JAX mesh, on the CPU.

The port's ranks are spawned processes over gloo (``tests/torch_parallel_ranks.py``:
they import only the port); the JAX side runs here, on the conftest's 8
virtual CPU devices.  Two spawned worlds, started together and joined with a
timeout: two ranks run (2, 1) and (1, 2), four run (2, 2), while this process
computes the JAX references and the port's one-device runs.

* The rank layout: rank r at (r // model, r % model), its data group the JAX
  mesh's column and its model group its row; a mesh that does not match the
  world raises as ``create_mesh`` does.
* Every port leaf's spec against the JAX spec of its flax leaf
  (``DEFAULT_RULES``), for the ``test_mesh_equivalence.py`` config and the
  flagship-shaped ``swin_micro``, on meshes whose model axis does and does not
  divide the fan-ins (replicated then, as ``_spec_fits`` has it).
* Loss and every gradient leaf at (2, 1), (1, 2) and (2, 2) against JAX
  ``value_and_grad`` on ``create_mesh(data, model, jax.devices()[:n])`` with
  ``shard_params`` / ``shard_batch``, on fixed views with dropout 0, at the
  JAX mesh test's tolerances (loss 1e-5, gradients 5e-4 relative).  The
  backbone is ``vit_micro_patch16_64`` (two blocks: the JAX compiles of the
  test's ``vit_tiny`` at three mesh shapes take ~35 s).  Two controls must
  fail: the roll's negative taken on a rank's own rows, and the model group's
  sum of a row-parallel product's input gradient dropped.
* ``swin_micro`` with BatchNorm heads, a factored ``second_proj`` sharded over
  the model axis (``factored_threshold`` 150000, d_out 256 so both its axes
  reach 128) and accumulation 2: three micro-steps of ``make_train_step`` on
  (2, 2) against the JAX step with optax, the running statistics and every
  replicated leaf bit for bit equal on every rank.
* Dropout on at (2, 2) against the port's one-device forward on the same
  generator, at 1e-6.
* The optimizer on (1, 2) against the one-device optimizer on whole leaves:
  factored statistics along and across the sharded axis, a bf16 leaf, the
  clip, a non-finite gradient in one rank's block skipping on every rank.
* The smoke-config ``Trainer`` on (2, 1) (host loader, each rank decoding its
  rows) and (1, 2) (device cache) against the one-device ``Trainer``, with
  the real augmentation and dropout: the draws are the global batch's.
* A checkpoint written on (2, 2) restored on the same mesh and on (1, 1), bit
  for bit; gradcheck of the four collectives; ``torchrun`` of the training CLI
  on two CPU ranks.
"""

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.data import shard_batch as j_shard_batch
from ego_moment_cle_vit_tpu.models import create_model as j_create_model
from ego_moment_cle_vit_tpu.parallel import create_mesh as j_create_mesh
from ego_moment_cle_vit_tpu.parallel import shard_params as j_shard_params
from ego_moment_cle_vit_tpu.parallel.sharding import DEFAULT_RULES as J_RULES
from ego_moment_cle_vit_tpu.parallel.sharding import _tree_paths_and_specs
from ego_moment_cle_vit_tpu.train.state import create_train_state as j_create_train_state
from ego_moment_cle_vit_tpu.utils import load_config
from ego_moment_cle_vit_tpu_torch import create_model, create_train_state
from ego_moment_cle_vit_tpu_torch.parallel import (
    create_mesh,
    load_params,
    mesh_shape,
    param_sharding_rules,
    param_specs,
    shard_params,
)
from ego_moment_cle_vit_tpu_torch.train import Trainer
from ego_moment_cle_vit_tpu_torch.train import state as tstate
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_ranks  # noqa: E402  (the spawned ranks' module, port only)

B, SIZE, NUM_CLASSES = 8, 64, 4
SHAPES = [(2, 1), (1, 2), (2, 2)]
JOIN_TIMEOUT = 360.0
# Dense biases a BatchNorm follows in training mode: zero gradient in exact
# arithmetic, so AdamW moves them by rounding noise (test_torch_engine_options.py)
AHEAD_OF_A_NORM = {"moment_head/second_proj/bias", "moment_head/third_proj/bias",
                   "classifier/fc1/bias", "classifier/fc2/bias"}


def _micro_config(dropout=0.0, backbone="vit_micro_patch16_64"):
    """``test_mesh_equivalence.py``'s config; ``backbone`` cut for speed."""
    return {
        "model": {
            "backbone_name": backbone, "norm": "layer", "bf16": False,
            "gpf": {"degree_p": 2, "degree_q": 2, "similarity": "cosine"},
            "moment": {"d_out": 64, "use_third_order": True, "isqrt_iterations": 3,
                       "sketch_dim": 256},
            "classifier": {"fusion_type": "concat", "hidden_dim": 32, "dropout": dropout},
        },
        "training": {"batch_size": B, "optimizer": {"lr": 1e-3}, "scheduler": {"warmup_epochs": 0},
                     "loss": {"lambda_triplet": 0.6, "lambda_align": 0.1, "margin": 0.3},
                     "epochs": 1},
        "data": {"input_size": SIZE, "resize_size": 80},
    }


def _swin_config(norm="batch"):
    """The flagship-shaped ``swin_micro`` of ``test_torch_training.py``, with
    BatchNorm heads, accumulation 2 and a ``second_proj`` wide enough (d_out
    256) to be factored along both axes."""
    return {
        "model": {
            "backbone_name": "swin_micro_patch4_window7_56", "norm": norm,
            "gpf": {"degree_p": 2, "degree_q": 2, "similarity": "dot"},
            "moment": {"d_out": 256, "sketch_dim": 256, "use_third_order": True,
                       "isqrt_iterations": 5},
            "classifier": {"fusion_type": "add", "dropout": 0.0},
        },
        "data": {"input_size": 56},
        "training": {
            "optimizer": {"lr": 3e-4, "eps": 1e-6, "factored_threshold": 150_000},
            "scheduler": {"warmup_epochs": 0}, "accumulation_steps": 2,
            "loss": {"lambda_triplet": 0.6, "lambda_align": 0.1, "margin": 0.3}, "epochs": 1,
        },
    }


def _views(seed, size=SIZE, labels=None):
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=(B, size, size, 3)).astype(np.float32)
    # far enough from the anchor that the triplet's hinge is open
    positive = (0.5 * anchor + rng.normal(size=anchor.shape)).astype(np.float32)
    if labels is None:
        labels = rng.integers(0, NUM_CLASSES, B).astype(np.int32)
    return anchor, positive, labels


def _jax_variables(cfg, size, seed=0):
    jm = j_create_model(cfg, num_classes=NUM_CLASSES)
    dummy = jnp.zeros((2, size, size, 3), jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), dummy, dummy,
                                 jnp.zeros((2,), jnp.int32))
    return jm, jax.tree_util.tree_map(np.asarray, variables)


def _port_state(cfg, variables):
    model = create_model(cfg, num_classes=NUM_CLASSES, device="cpu")
    return torch_state_dict_from_flax(variables, model, device="cpu")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _as_flax(named: dict, cfg, collection="params") -> dict:
    model = create_model(cfg, num_classes=NUM_CLASSES, device="cpu")
    tensors = {n: torch.from_numpy(np.asarray(v)) for n, v in named.items()}
    return _flat(flax_tree_from_named_tensors(tensors, model)[collection])


def _jax_loss_and_grads(jm, variables, views, data, model):
    mesh = j_create_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    params = j_shard_params(variables["params"], mesh)

    def loss_fn(params, anchor, positive, labels):
        out = jm.apply({"params": params, "constants": variables["constants"]}, anchor, positive,
                       labels, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return out["loss"], out["loss_dict"]

    with mesh:
        batch = j_shard_batch(views, mesh)
        (loss, terms), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, *batch)
    return float(loss), {k: float(v) for k, v in terms.items()}, _flat(jax.device_get(grads))


def _jax_bn_steps(jm, variables, cfg, views):
    """Three micro-steps of the JAX step with optax (MultiSteps over 2)."""
    state = j_create_train_state(jm, jax.tree_util.tree_map(jnp.asarray, variables), cfg, 100)

    @jax.jit
    def step(state, anchor, positive, labels):
        def loss_fn(params):
            out, mutated = jm.apply(
                {"params": params, "constants": state.constants,
                 "batch_stats": state.batch_stats}, anchor, positive, labels,
                deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            return out["loss"], mutated["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return state.apply_gradients(grads=grads).replace(batch_stats=stats), loss

    losses = []
    for anchor, positive, labels in views:
        state, loss = step(state, jnp.asarray(anchor), jnp.asarray(positive), jnp.asarray(labels))
        losses.append(float(loss))
    return (losses, _flat(jax.device_get(state.params)),
            _flat(jax.device_get(state.batch_stats)), _flat(variables["params"]))


def _trainer_config(tmp: Path, tag: str, mesh: dict, device_cache: bool) -> dict:
    cfg = load_config(str(REPO / "configs" / "smoke_synthetic.yaml"))
    for key in ("output_dir", "save_dir", "log_dir"):
        cfg["experiment"][key] = str(tmp / tag / key)
    cfg["experiment"].update(mesh=mesh, name=tag)
    cfg["model"]["backbone_name"] = "vit_micro_patch16_64"
    cfg["training"]["optimizer"]["eps"] = 1e-6
    cfg["data"].update(device_cache=device_cache, host_cache=False, num_workers=1)
    return cfg


def _spawn(world: int, out: Path, tasks: list):
    out.mkdir(parents=True, exist_ok=True)
    return tmp.start_processes(torch_parallel_ranks.run,
                               args=(world, str(out / "store"), str(out), tasks),
                               nprocs=world, join=False, start_method="spawn")


def _join(ctx, out: Path, world: int, deadline: float) -> list:
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world} spawned ranks did not finish")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp_dir = tmp_path_factory.mktemp("mesh")
    two, four = tmp_dir / "two", tmp_dir / "four"
    micro_cfg = _micro_config()
    jm, variables = _jax_variables(micro_cfg, SIZE)
    views = _views(7)
    inputs = {"config": micro_cfg, "num_classes": NUM_CLASSES,
              "state": _port_state(micro_cfg, variables),
              **dict(zip(("anchor", "positive", "labels"), views))}
    drop_cfg = _micro_config(dropout=0.1)
    swin_cfg = _swin_config()
    sjm, svars = _jax_variables(swin_cfg, 56, seed=3)
    swin_views = [_views(10 + i, 56) for i in range(3)]
    for d in (two, four):
        d.mkdir()
        torch.save(inputs, d / "micro.pt")
    torch.save({**inputs, "config": drop_cfg}, four / "dropout.pt")
    torch.save({"config": swin_cfg, "num_classes": NUM_CLASSES, "views": swin_views,
                "state": _port_state(swin_cfg, svars)}, four / "swin_bn.pt")
    trainer_cfgs = {(2, 1): _trainer_config(tmp_dir, "t21", {"data": 2, "model": 1}, False),
                    (1, 2): _trainer_config(tmp_dir, "t12", {"data": None, "model": 2}, True)}
    for (d, m), cfg in trainer_cfgs.items():
        torch.save(cfg, two / f"trainer_{d}x{m}.pt")

    deadline = time.monotonic() + JOIN_TIMEOUT
    ctx_two = _spawn(2, two, [("gradcheck",), ("layout", 1, 2), ("grads", 2, 1),
                              ("grads", 1, 2), ("controls",), ("optimizer",),
                              ("trainer", 2, 1), ("trainer", 1, 2)])
    ctx_four = _spawn(4, four, [("layout", 2, 2), ("grads", 2, 2), ("dropout", 2, 2),
                                ("bn_steps", 2, 2)])
    try:
        # meanwhile, the references
        ref = {"jax_grads": {s: _jax_loss_and_grads(jm, variables, views, *s) for s in SHAPES},
               "jax_params": _flat(variables["params"]),
               "jax_bn": _jax_bn_steps(sjm, svars, swin_cfg, swin_views)}
        one = Trainer(_trainer_config(tmp_dir, "t11", {"data": None, "model": 1}, True),
                      device="cpu")
        one.setup_data()
        one.setup_model()
        ref["trainer"] = one.train()
        ref["trainer_params"] = {n: p.detach().numpy().copy()
                                 for n, p in one.model.state_dict().items()}
        ranks_two = _join(ctx_two, two, 2, deadline)
        ranks_four = _join(ctx_four, four, 4, deadline)
    finally:
        for ctx in (ctx_two, ctx_four):
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    return {"two": ranks_two, "four": ranks_four, "ref": ref, "dir": tmp_dir,
            "micro_cfg": micro_cfg, "drop_cfg": drop_cfg, "swin_cfg": swin_cfg,
            "trainer_cfgs": trainer_cfgs}


def _rank0(runs, shape):
    return runs["four"][0] if shape == (2, 2) else runs["two"][0]


def _grads(res: dict, tag: str, cfg) -> dict:
    prefix = f"{tag}/grad/"
    return _as_flax({k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}, cfg)


def _worst(got: dict, ref: dict, rtol: float, atol: float) -> float:
    """The largest |got - ref| / (atol + rtol |ref|) over every leaf."""
    assert sorted(got) == sorted(ref) and len(ref) > 40
    return max(float(np.max(np.abs(got[k] - r) / (atol + rtol * np.abs(r))))
               for k, r in ref.items())


# -- layout and specs --------------------------------------------------------------


@pytest.mark.parametrize("data, model", [(2, 1), (1, 2), (2, 2)])
def test_rank_layout_is_the_jax_mesh(runs, data, model):
    ids = np.vectorize(lambda d: d.id)(
        j_create_mesh(data, model, jax.devices()[:data * model]).devices)
    ranks = runs["four"] if (data, model) == (2, 2) else runs["two"]
    for r, res in enumerate(ranks):
        tag = f"layout_{data}x{model}"
        if f"{tag}/data" not in res:
            continue
        d, m = res[f"{tag}/index"]
        assert ids[d, m] == r
        assert res[f"{tag}/data"].tolist() == ids[:, m].tolist()
        assert res[f"{tag}/model"].tolist() == ids[d, :].tolist()


@pytest.mark.parametrize("data, model, world", [(3, 1, 2), (1, 3, 2), (2, 2, 8)])
def test_a_mesh_that_does_not_match_the_world_raises(data, model, world):
    with pytest.raises(ValueError, match=rf"mesh {data}x{model} != {world} devices"):
        j_create_mesh(data, model, jax.devices()[:world])
    with pytest.raises(ValueError, match=rf"mesh {data}x{model} != {world} devices"):
        mesh_shape(data, model, world)
    assert mesh_shape(None, 2, 8) == (4, 2)


# the heads' variants: the rules match by name, so a variant shards the
# leaves its flax twin has under the rules' names (the adaptive and bilinear
# classifiers' fc1 too)
HEAD_VARIANTS = {"adaptive": {"classifier": {"type": "adaptive"}},
                 "multiscale": {"classifier": {"type": "multiscale"}},
                 "bilinear": {"classifier": {"fusion_type": "bilinear", "hidden_dim": 64}},
                 "simplified": {"moment": {"variant": "simplified"}}}
SPEC_CASES = ([(v, d, m) for v in ("vit_tiny", "swin_micro")
               for d, m in [(2, 1), (1, 2), (2, 2), (1, 3), (2, 4)]]
              + [(v, 1, m) for v in HEAD_VARIANTS for m in (2, 3)])


@pytest.fixture(scope="module")
def variant_models():
    """{variant: (the port model, the flax parameter shapes)}, built once."""
    cache = {}

    def get(variant):
        if variant not in cache:
            if variant == "vit_tiny":
                cfg, size = _micro_config(backbone="vit_tiny_patch16_224"), SIZE
            else:
                cfg, size = _swin_config(norm="layer"), 56
                for section, opts in HEAD_VARIANTS.get(variant, {}).items():
                    cfg["model"][section].update(opts)
            dummy = jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)
            shapes = jax.eval_shape(j_create_model(cfg, num_classes=NUM_CLASSES).init,
                                    jax.random.PRNGKey(0), dummy, dummy)
            cache[variant] = (create_model(cfg, num_classes=NUM_CLASSES, device="cpu"),
                              shapes["params"])
        return cache[variant]

    return get


@pytest.mark.parametrize("variant, data, model", SPEC_CASES)
def test_every_leaf_spec_is_the_jax_spec(variant_models, variant, data, model):
    port, shapes = variant_models(variant)
    jmesh = j_create_mesh(data, model, jax.devices()[:data * model])
    jspecs = _tree_paths_and_specs(shapes, J_RULES, jmesh)
    specs = param_specs(port, SimpleNamespace(shape={"data": data, "model": model}))
    # each port leaf tagged with its index, carried to its flax leaf
    names = list(specs)
    tagged = {n: torch.full(p.shape, float(i)) for i, (n, p) in
              enumerate(port.named_parameters())}
    flax = flax_tree_from_named_tensors(tagged, port)["params"]
    sharded = 0
    for path, leaf in _flat(flax).items():
        name = names[int(leaf.flat[0])]
        node = jspecs
        for k in path.split("/"):
            node = node[k]
        want = tuple(node)
        got = specs[name]
        if got and port.get_parameter(name).dim() == 2 and leaf.ndim == 2:
            got = tuple(reversed(got))  # the port's Dense weight is [out, in]
        assert got == want, (path, name)
        sharded += bool(want) and model > 1
    # the three rules' leaves shard wherever the model axis divides their fan-in
    fits = {n: port.get_parameter(n).shape[1] % model == 0
            for n in names if param_sharding_rules(n)}
    assert len(fits) >= 2
    assert sharded == (sum(fits.values()) if model > 1 else 0)
    if model == 3:
        assert not all(fits.values())  # a fallback to replicated is in the case


# -- gradients against the JAX mesh --------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_loss_and_every_gradient_match_the_jax_mesh(runs, shape):
    res = _rank0(runs, shape)
    tag = f"grads_{shape[0]}x{shape[1]}"
    ref_loss, ref_terms, ref_grads = runs["ref"]["jax_grads"][shape]
    np.testing.assert_allclose(float(res[f"{tag}/loss"]), ref_loss, rtol=1e-5, atol=1e-6)
    for k, v in ref_terms.items():
        np.testing.assert_allclose(float(res[f"{tag}/term/{k}"]), v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    got = _grads(res, tag, runs["micro_cfg"])
    assert _worst(got, ref_grads, rtol=5e-4, atol=1e-5) <= 1.0
    # every rank holds the same summed gradients
    ranks = runs["four"] if shape == (2, 2) else runs["two"]
    for other in ranks[1:]:
        for k in res:
            if k.startswith(f"{tag}/"):
                np.testing.assert_array_equal(other[k], res[k], err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gathered_parameters_are_the_jax_tree(runs, shape):
    """``gather_params`` then ``flax_tree_from_named_tensors`` gives back the
    JAX tree the weights came from, leaf for leaf, bit for bit."""
    res = _rank0(runs, shape)
    prefix = f"grads_{shape[0]}x{shape[1]}/param/"
    named = {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}
    got = _as_flax({k: v for k, v in named.items() if "sketch" not in k}, runs["micro_cfg"])
    ref = runs["ref"]["jax_params"]
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k], r, err_msg=k)


@pytest.mark.parametrize("control, shape", [("local_roll", (2, 1)), ("no_dx_reduce", (1, 2))])
def test_each_control_is_rejected(runs, control, shape):
    res = runs["two"][0]
    ref_loss, ref_terms, ref_grads = runs["ref"]["jax_grads"][shape]
    assert ref_terms["loss_triplet"] > 1e-3  # the roll's term is live on these views
    loss_off = abs(float(res[f"{control}/loss"]) - ref_loss) > 1e-5 * abs(ref_loss) + 1e-6
    worst = _worst(_grads(res, control, runs["micro_cfg"]), ref_grads, rtol=5e-4, atol=1e-5)
    assert loss_off or worst > 1.0
    if control == "no_dx_reduce":
        assert not loss_off and worst > 1.0  # the forward is right, the gradients are not


def test_dropout_on_matches_the_one_device_run(runs):
    res = runs["four"][0]
    np.testing.assert_allclose(float(res["dropout/loss"]), float(res["dropout_one/loss"]),
                               rtol=1e-6)
    got = _grads(res, "dropout", runs["drop_cfg"])
    ref = _grads(res, "dropout_one", runs["drop_cfg"])
    for k, r in ref.items():
        assert np.max(np.abs(got[k] - r)) <= 1e-6 * max(np.max(np.abs(r)), 1e-30), k
    # the masks really dropped: the run differs from the dropout-free one
    assert float(res["dropout/loss"]) != float(res["grads_2x2/loss"])


def test_the_collectives_pass_gradcheck(runs):
    res = runs["two"][0]
    checks = {k: bool(v) for k, v in res.items() if k.startswith("gradcheck/")}
    assert len(checks) == 3 and all(checks.values()), checks


# -- the optimizer, BatchNorm and accumulation on a mesh ---------------------------


def test_the_sharded_optimizer_is_the_one_device_optimizer(runs):
    res = runs["two"][0]
    applied = res["optimizer/applied"]
    assert applied.tolist() == [[True, True], [True, True], [False, False], [True, True]]
    assert res["optimizer/counts"].tolist() == [[3, 1], [3, 1]]
    assert bool(res["optimizer/factored"][0]) and res["optimizer/factored"][1] == 3
    assert bool(res["optimizer/state_equal_shapes"])
    # fp32 sums in another order (1e-6); the factored leaves' momentum is held
    # in bf16, where a rounding flip is one bf16 ulp (2^-8) of it and moves
    # each later update by lr x that (two such over the steps: 2^-7 of the
    # leaf's largest momentum); the bf16 leaf also at its own ulp
    lr = 1e-2
    for k in [k for k in res if k.startswith(("optimizer/param/", "optimizer/state/"))]:
        one = res[k.replace("optimizer/param/", "optimizer/param_one/").replace(
            "optimizer/state/", "optimizer/state_one/")]
        name = k.rsplit("/", 1)[1]
        ema = res.get(f"optimizer/state_one/ema/{name}")
        if k.startswith("optimizer/param/") and ema is not None:
            bound = 1e-6 + 2.0**-7 * (lr * np.abs(ema).max() + (np.abs(one) if "half" in k else 0))
            bad = np.abs(res[k] - one) > bound
            assert not bad.any(), (k, res[k][bad], one[bad])
        elif "/ema/" in k:
            np.testing.assert_allclose(res[k], one, rtol=0, atol=2.0**-7 * np.abs(one).max(),
                                       err_msg=k)
        else:
            rtol = 2.0**-7 if "half" in k else 1e-6
            np.testing.assert_allclose(res[k], one, rtol=rtol, atol=1e-6, err_msg=k)


def test_batchnorm_factored_accumulation_steps_match_optax(runs):
    ranks = runs["four"]
    res = ranks[0]
    losses, ref_params, ref_stats, start = runs["ref"]["jax_bn"]
    np.testing.assert_allclose(res["bn/loss"], losses, rtol=1e-4)
    assert res["bn/counts"].tolist() == [3, 1, 0]
    assert "moment_head.second_proj.weight" in res["bn/factored"].tolist()
    whole = {k[len("bn/whole/"):]: v for k, v in res.items() if k.startswith("bn/whole/")}
    cfg = runs["swin_cfg"]
    params = _as_flax({k: v for k, v in whole.items() if not k.startswith("running")
                       and "running_" not in k and "sketch" not in k}, cfg)
    # AdamW's first update is lr g / (|g| + eps): where |g| is near eps it
    # turns the gradients' fp32 rounding (another sum order here) into a
    # share of the update itself (measured 1.3e-5 on 4 of ~560k entries, at
    # lr 3e-4), so each entry is held to a tenth of lr and the leaf's largest
    # moved entries to the update's own scale
    lr = 3e-4
    for k, r in ref_params.items():
        if k in AHEAD_OF_A_NORM:
            continue
        diff = np.abs(params[k] - r)
        assert diff.max() <= 0.1 * lr, k
        assert np.mean(diff <= 1e-5) >= 0.999, k
        assert np.abs(r - start[k]).max() > 1e-6, k  # it moved
    stats = _as_flax({k: v for k, v in whole.items() if "running_" in k}, cfg, "batch_stats")
    assert sorted(stats) == sorted(ref_stats) and stats
    for k, r in ref_stats.items():  # test_torch_engine_options.py's scale
        scale = np.sqrt(ref_stats[k[:-len("mean")] + "var"].max()) if k.endswith("mean") \
            else r.max()
        np.testing.assert_allclose(stats[k], r, rtol=0, atol=1e-5 * scale, err_msg=k)
    # every rank alike: replicated leaves and running statistics bit for bit,
    # a sharded leaf equal on the ranks that hold the same block
    sharded = {"moment_head.second_proj.weight", "moment_head.third_proj.weight",
               "classifier.fc1.weight"}
    for r, other in enumerate(ranks[1:], start=1):
        for k in [k for k in res if k.startswith("bn/local/")]:
            if k[len("bn/local/"):] in sharded and r % 2:
                continue
            np.testing.assert_array_equal(other[k], res[k], err_msg=f"rank {r}: {k}")
    assert not np.array_equal(ranks[1]["bn/local/moment_head.second_proj.weight"],
                              res["bn/local/moment_head.second_proj.weight"])


def test_a_checkpoint_from_the_mesh_restores_bit_for_bit(runs):
    assert all(bool(r["bn/restored_on_mesh"]) for r in runs["four"])
    four = runs["dir"] / "four"
    gathered = torch.load(four / "bn_gathered.pt", weights_only=False)
    store = runs["dir"] / "one_store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        mesh = create_mesh(1, 1, ["cpu"])
        cfg = runs["swin_cfg"]
        model = create_model(cfg, num_classes=NUM_CLASSES, device="cpu")
        assert shard_params(model, mesh) == {}
        state = create_train_state(model, cfg, 100, device="cpu", mesh=mesh)
        bundle = tstate.restore_checkpoint(str(four / "bn_ckpt" / "checkpoint_epoch_0"),
                                           device="cpu")
        assert bundle["step"] == 3
        load_params(model, bundle["model"], mesh)
        state.optimizer.load_state_dict(bundle["optimizer"])
        for n, t in model.state_dict().items():
            assert torch.equal(t, gathered["model"][n]), n
        mine = state.optimizer.state_dict()
        for k in tstate.Optimizer._STATE_TENSORS:
            assert sorted(mine[k]) == sorted(gathered["optimizer"][k]), k
            for n, t in mine[k].items():
                assert torch.equal(t, gathered["optimizer"][k][n]), (k, n)
        assert mine["count"] == 1 and mine["mini_step"] == 1
    finally:
        dist.destroy_process_group()
    # rank 0 alone wrote the files
    assert sorted(p.name for p in (four / "bn_ckpt").iterdir()) == [
        "checkpoint_epoch_0", "checkpoint_epoch_0.meta.json"]


# -- the trainer and the CLI -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1_host_loader", "1x2_device_cache"])
def test_trainer_on_a_mesh_is_the_one_device_trainer(runs, shape):
    res = {k[len(f"trainer_{shape[0]}x{shape[1]}/"):]: v for k, v in runs["two"][0].items()
           if k.startswith(f"trainer_{shape[0]}x{shape[1]}/")}
    ref = runs["ref"]["trainer"]
    hist = ref["history"]
    assert len(hist["train_loss"]) == 2
    for key, values in hist.items():
        if key.endswith("acc"):
            np.testing.assert_array_equal(res[key], values, err_msg=key)
        else:
            np.testing.assert_allclose(res[key], values, rtol=1e-4, err_msg=key)
    assert float(res["best_val_acc"]) == ref["best_val_acc"]
    for n, r in runs["ref"]["trainer_params"].items():
        np.testing.assert_allclose(res[f"param/{n}"], r, rtol=0, atol=1e-5, err_msg=n)
    # the checkpoints are there; rank 0 alone logged
    exp = runs["trainer_cfgs"][shape]["experiment"]
    saved = {p.name for p in Path(exp["save_dir"]).iterdir()}
    assert {"checkpoint_epoch_0", "checkpoint_epoch_1", "checkpoint_epoch_1.meta.json"} <= saved
    log = (Path(exp["log_dir"]) / f"{exp['name']}.log").read_text()
    assert log.count("epoch 1 done") == 1 and f"mesh data={shape[0]} model={shape[1]}" in log


def test_torchrun_trains_on_two_cpu_ranks(tmp_path):
    import yaml

    cfg = _trainer_config(tmp_path, "cli", {"data": None, "model": 1}, True)
    cfg["training"]["epochs"] = 1
    path = tmp_path / "cli.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "ego_moment_cle_vit_tpu_torch.cli.train", "--config", str(path),
         "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("best val accuracy") == 1
    assert (tmp_path / "cli" / "save_dir" / "checkpoint_epoch_0" / "model.pt").exists()
    log = (tmp_path / "cli" / "log_dir" / "cli.log").read_text()
    assert "mesh data=2 model=1" in log and log.count("epoch 0 done") == 1
