"""The port's hand-written optimizer against the JAX package's optax chain.

The same parameters and the same gradient sequence (numpy, from a seed) go
through ``ego_moment_cle_vit_tpu.train.state.create_optimizer`` +
``optax.apply_updates`` and through the port's ``Optimizer``.  The port holds
Dense-like 2-D leaves transposed (``[out, in]``), as its modules do, so the
factored statistics are checked across that layout change.

Tolerances: fp32 leaves 2e-6 absolute per step on parameters of size ~1 (a
dozen fp32 operations in another order, lr 1e-3), 5e-5 for the factored
leaves, whose momentum is held in bf16: an fp32 difference of one ulp can
round it to the neighbouring bf16 value, which moves the parameter by
lr x b1 x 2^-8 x |update| ~ 4e-6 in that step and, decaying by b1, by up to
ten times that over the steps that follow; bf16 leaves one bf16 ulp
(2^-7 relative) plus 1e-5 absolute: the port sets the leaf to bf16(new
master), the JAX chain adds ``bf16(bf16(new master) - param)``, a difference
that is itself rounded to bf16 and so is off by up to 2^-9 of the update's
size (~2e-6 here), which shows on entries much smaller than their update.  Schedules:
2e-5 relative (optax evaluates them in fp32, and its end value carries that
rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from ego_moment_cle_vit_tpu.train import state as jstate
from ego_moment_cle_vit_tpu_torch.train import state as tstate

# the test workers share the cores, and these sizes are tiny: one intra-op thread
# per worker keeps torch's thread pools from contending with each other
torch.set_num_threads(1)

# flax-layout shapes; 2-D ones are held transposed by the port
LEAVES = {
    "dense": ((5, 7), np.float32),
    "bias": ((7,), np.float32),
    "dense_bf16": ((6, 4), jnp.bfloat16),          # AdamW on an fp32 master
    "factored": ((130, 140), np.float32),          # row / column statistics
    "factored_bf16": ((256, 128), jnp.bfloat16),   # the same on an fp32 master
    "tall": ((400, 32), np.float32),               # big but one axis < 128: full second moment
}
TRANSPOSED = {n for n, (shape, _) in LEAVES.items() if len(shape) == 2}


def _config(**training):
    cfg = {"training": {
        "optimizer": {"lr": 1e-3, "factored_threshold": 10_000, "weight_decay": 0.05},
        "scheduler": {"name": "cosine", "warmup_epochs": 1, "min_lr": 1e-5},
        "epochs": 4,
    }}
    cfg["training"].update(training)
    return cfg


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {n: jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
            for n, (shape, dtype) in LEAVES.items()}


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {n: jnp.asarray((rng.normal(size=shape) * scale).astype(np.float32), dtype)
            for n, (shape, dtype) in LEAVES.items()}


def _to_torch(tree):
    out = {}
    for n, v in tree.items():
        t = torch.from_numpy(np.array(v.astype(jnp.float32)))
        if v.dtype == jnp.bfloat16:
            t = t.bfloat16()
        out[n] = (t.t().contiguous() if n in TRANSPOSED else t).clone()
    return out


def _assert_same(tparams, jparams, what):
    for n, jv in jparams.items():
        tv = tparams[n].t() if n in TRANSPOSED else tparams[n]
        ref = np.asarray(jv.astype(jnp.float32))
        if jv.dtype == jnp.bfloat16:
            np.testing.assert_allclose(tv.float().numpy(), ref, rtol=2.0**-7, atol=1e-5,
                                       err_msg=f"{what}: {n}")
        else:
            atol = 5e-5 if n in ("factored", "tall") else 2e-6
            np.testing.assert_allclose(tv.numpy(), ref, rtol=0, atol=atol,
                                       err_msg=f"{what}: {n}")


def _run_both(cfg, grad_sequence, steps_per_epoch=3):
    jparams = _params()
    tx = jstate.create_optimizer(cfg, steps_per_epoch)
    jopt = tx.init(jparams)
    tparams = _to_torch(jparams)
    opt = tstate.create_optimizer(cfg, steps_per_epoch).init(tparams, TRANSPOSED)
    applied = []
    for i, grads in enumerate(grad_sequence):
        updates, jopt = tx.update(grads, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied.append(opt.step(_to_torch(grads)))
        yield i, tparams, jparams, opt, jopt, applied


def test_leaves_are_classified_like_the_jax_labels():
    opt = tstate.create_optimizer(_config(), 3).init(_to_torch(_params()), TRANSPOSED)
    assert sorted(opt.factored) == ["factored", "factored_bf16", "tall"]
    assert sorted(opt.master) == ["dense_bf16", "factored_bf16"]
    assert opt.factored_axes["tall"] is None and opt.v["tall"].shape == (32, 400)
    # flax [130, 140]: v_row over the 130 axis has 130 entries, v_col 140
    assert opt.v_row["factored"].shape == (130,) and opt.v_col["factored"].shape == (140,)
    assert opt.ema["factored_bf16"].dtype == torch.bfloat16
    assert opt.master["dense_bf16"].dtype == torch.float32


def test_steps_match_optax_through_clip_skip_and_recovery():
    """Step 0 is under the clip norm, steps 1-2 and 4-5 are clipped, step 3
    has an inf and must be skipped without touching parameters or state."""
    seq = [_grads(10, 1e-3), _grads(11, 1.0), _grads(12, 3.0)]
    bad = _grads(13, 1.0)
    bad["dense"] = bad["dense"].at[0, 0].set(jnp.inf)
    seq += [bad, _grads(14, 1.0), _grads(15, 0.5)]
    before_bad = None
    for i, tparams, jparams, opt, jopt, applied in _run_both(_config(), seq):
        _assert_same(tparams, jparams, f"step {i}")
        if i == 0:
            assert opt.last_grad_norm < 1.0
        if i == 2:
            assert opt.last_grad_norm > 1.0
            before_bad = {n: v.clone() for n, v in tparams.items()}
        if i == 3:
            assert applied[-1] is False and opt.notfinite_count == 1 and opt.count == 3
            assert all(torch.equal(before_bad[n], tparams[n]) for n in tparams)
            assert int(jopt.notfinite_count) == 1 and int(jopt.total_notfinite) == 1
    assert applied == [True, True, True, False, True, True]
    assert opt.count == 5 and opt.notfinite_count == 0 and opt.total_notfinite == 1
    assert int(jopt.notfinite_count) == 0


def test_poison_after_the_limit_of_consecutive_nonfinite_steps():
    bad = _grads(20, 1.0)
    bad["bias"] = bad["bias"].at[1].set(jnp.nan)
    cfg = _config(max_nonfinite_steps=2)
    for i, tparams, jparams, opt, jopt, applied in _run_both(cfg, [bad, bad, bad]):
        poisoned = i == 2  # the third consecutive bad step exceeds the limit of 2
        for n in tparams:
            assert bool(torch.isnan(tparams[n].float()).all()) == poisoned
            assert bool(np.isnan(np.asarray(jparams[n].astype(jnp.float32))).all()) == poisoned


@pytest.mark.parametrize("training", [
    {"grad_clip": 0.0},                                     # containment without rescaling
    {"skip_nonfinite_updates": False},                      # plain fp32 clip
    {"skip_nonfinite_updates": False, "grad_clip": 0.0},    # neither
    {"optimizer": {"lr": 1e-3, "factored_large_leaves": False, "betas": [0.8, 0.99],
                   "eps": 1e-6, "weight_decay": 0.0}},      # dense AdamW everywhere
    {"scheduler": {"name": "constant", "warmup_epochs": 2, "warmup_lr": 1e-4}},
])
def test_option_variants_match_optax(training):
    seq = [_grads(30, 0.01), _grads(31, 2.0), _grads(32, 1.0)]
    for i, tparams, jparams, *_ in _run_both(_config(**training), seq):
        _assert_same(tparams, jparams, f"step {i}")


@pytest.mark.parametrize("scheduler, epochs", [
    ({"name": "cosine", "warmup_epochs": 2, "warmup_lr": 1e-5, "min_lr": 1e-6}, 10),
    ({"name": "cosine", "warmup_epochs": 0}, 1),
    ({"name": "constant", "warmup_epochs": 3}, 5),
    ({"name": "constant"}, 5),
])
def test_schedules_match_optax(scheduler, epochs):
    cfg = {"training": {"optimizer": {"lr": 3e-4}, "scheduler": scheduler, "epochs": epochs}}
    ref = jstate.create_learning_rate_schedule(cfg, 7)
    out = tstate.create_learning_rate_schedule(cfg, 7)
    for count in (0, 1, 6, 7, 13, 14, 20, 21, 50, 69, 70, 500):
        assert out(count) == pytest.approx(float(ref(count)), rel=2e-5, abs=1e-12)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tstate.create_learning_rate_schedule(
            {"training": {"scheduler": {"name": "step"}}}, 7)


def test_unported_training_options_raise_and_gradients_are_required(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstate.create_optimizer(_config(accumulation_steps=2), 3)
    opt = tstate.create_optimizer(_config(), 3).init({"w": torch.zeros(3, requires_grad=True)})
    with pytest.raises(ValueError, match="no gradient"):
        opt.step()

    # save_checkpoint / restore_checkpoint: two steps, a checkpoint, two more
    # steps; a fresh optimizer restored from the checkpoint takes the same two
    # steps to the same bits (masters, factored statistics, bf16 momentum)
    def fresh():
        module = torch.nn.Module()
        for n, t in _to_torch(_params()).items():
            module.register_parameter(n, torch.nn.Parameter(t))
        state = tstate.TrainState(module, tstate.create_optimizer(_config(), 3).init(
            dict(module.named_parameters()), TRANSPOSED))
        return module, state

    def grads(seeds):  # fresh tensors: the step clips its gradients in place
        return [_to_torch(_grads(seed, 0.1)) for seed in seeds]

    module, state = fresh()
    for g in grads((0, 1)):
        assert state.optimizer.step(g)
        state.step += 1
    tstate.save_checkpoint(str(tmp_path), state, 0, 0.0, _config())
    for g in grads((2, 3)):
        state.optimizer.step(g)
    bundle = tstate.restore_checkpoint(str(tmp_path / "checkpoint_epoch_0"), device="cpu")
    assert bundle["step"] == 2 and bundle["epoch"] == 0
    module2, state2 = fresh()
    module2.load_state_dict(bundle["model"])
    state2.optimizer.load_state_dict(bundle["optimizer"])
    for g in grads((2, 3)):
        state2.optimizer.step(g)
    for n, p in module.named_parameters():
        assert torch.equal(p, getattr(module2, n)), n
    assert state2.optimizer.count == state.optimizer.count == 4
