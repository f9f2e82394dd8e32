"""The port's trainer, evaluator, checkpoints and CLI against the JAX package's.

``configs/smoke_synthetic.yaml`` loaded on the CPU, with three changes for
the parity runs: the backbone is ``vit_micro_patch16_64`` (two blocks, 64
wide: the JAX trainer's compile of ``vit_tiny``'s twelve blocks would take
most of this file's time), dropout 0, and AdamW's eps 1e-6 in place of 1e-8,
as in ``tests/test_torch_training.py``: a gradient that is zero in exact
arithmetic (a key bias under softmax) is rounding noise of ~1e-9 in both
frameworks, and eps 1e-8 turns that noise into updates of full size lr with a
random sign (measured: 1.2e-4 apart on ``blocks_0/attn/qkv/bias`` after two
epochs, against 2.7e-6 with eps 1e-6).

* Trainer parity: both trainers start from the JAX trainer's initial weights
  (carried across by ``torch_state_dict_from_flax``) and get the same views:
  the train step's augmentation is patched on both sides to the eval views
  with the positive view mirrored.  Over 2 epochs: per-epoch train and val
  loss and every loss term within 1e-4 relative, accuracies and
  ``best_val_acc`` equal, the lr history within 1e-6 relative (optax holds it
  in fp32), final parameters within 1e-5 absolute per leaf (the three-step
  test's bar; measured 2.7e-6).
* Resume equals uninterrupted, bit for bit, with the real augmentation; with
  the optimizer's moments zeroed it does not.
* Checkpoints: CPU -> CPU round trip, ``keep`` pruning, the meta sidecar.
* Evaluator parity: the JAX evaluator's weights (the JAX trainer's best
  checkpoint) carried to the port.  Top-1, top-5, mean per-class recall, the
  per-class report, the three ablation accuracies and TTA top-1 equal; the
  logits within 1e-4 of max |logit|.  TTA's views per element within 1e-5 of
  the JAX evaluator's at scales 0.9, 1.0 and 1.1 (``jax.image.resize``).
* The CLI: ``--help`` of the three modules, one epoch of ``cli/train.py`` on
  the smoke config with ``--device cpu``.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ego_moment_cle_vit_tpu.data import augment as jaug
from ego_moment_cle_vit_tpu.train import evaluator as jevaluator
from ego_moment_cle_vit_tpu.train import trainer as jtrainer
from ego_moment_cle_vit_tpu.utils import load_config
from ego_moment_cle_vit_tpu_torch import create_model
from ego_moment_cle_vit_tpu_torch.cli import eval as cli_eval
from ego_moment_cle_vit_tpu_torch.cli import predict as cli_predict
from ego_moment_cle_vit_tpu_torch.cli import train as cli_train
from ego_moment_cle_vit_tpu_torch.data import augment as taug
from ego_moment_cle_vit_tpu_torch.train import Evaluator, Trainer
from ego_moment_cle_vit_tpu_torch.train import state as tstate
from ego_moment_cle_vit_tpu_torch.train import step as tstep
from ego_moment_cle_vit_tpu_torch.train.evaluator import tta_view
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)

torch.set_num_threads(1)

CFG_PATH = Path(__file__).resolve().parent.parent / "configs" / "smoke_synthetic.yaml"
TTA_SCALES = (0.9, 1.0, 1.1)


def _config(tmp: Path, tag: str, parity: bool = True) -> dict:
    cfg = load_config(str(CFG_PATH))
    for key in ("output_dir", "save_dir", "log_dir"):
        cfg["experiment"][key] = str(tmp / tag / key)
    if parity:
        cfg["model"]["backbone_name"] = "vit_micro_patch16_64"
        cfg["model"]["classifier"]["dropout"] = 0.0
        cfg["training"]["optimizer"]["eps"] = 1e-6
    cfg["evaluation"]["tta"] = {"enabled": True, "scales": list(TTA_SCALES)}
    return cfg


def _jax_views(images, key, aug_cfg):
    anchor, positive = jaug.dual_view_eval_batch(images, aug_cfg)
    return anchor, positive[:, :, ::-1, :]


def _port_views(images, generator, aug_cfg):
    anchor, positive = taug.dual_view_eval_batch(images, aug_cfg)
    return anchor, positive.flip(2)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX and the port trainer, 2 epochs each on the same views from the
    same initial weights."""
    tmp = tmp_path_factory.mktemp("engine")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "dual_view_train_batch", _jax_views)
        mp.setattr(tstep, "dual_view_train_batch", _port_views)
        jt = jtrainer.Trainer(_config(tmp, "jax"))
        jt.setup_data()
        jt.setup_model()
        tt = Trainer(_config(tmp, "port"), device="cpu")
        tt.setup_data()
        tt.setup_model()
        variables = {"params": jax.device_get(jt.state.params),
                     "constants": jax.device_get(jt.state.constants)}
        tt.model.load_state_dict(torch_state_dict_from_flax(variables, tt.model, device="cpu"))
        jres = jt.train()
        tres = tt.train()
    return {"tmp": tmp, "jax": jt, "port": tt, "jres": jres, "tres": tres}


def test_trainer_matches_jax(trained):
    jh, th = trained["jres"]["history"], trained["tres"]["history"]
    assert sorted(th) == sorted(jh)
    assert {"train_loss_main_ce", "train_loss_triplet", "train_loss_align"} <= set(th)
    for key, ref in jh.items():
        assert len(th[key]) == len(ref) == 2, key
        if key in ("train_acc", "val_acc"):
            assert th[key] == [float(v) for v in ref], key
        elif key == "lr":
            np.testing.assert_allclose(th[key], ref, rtol=1e-6)
        else:
            np.testing.assert_allclose(th[key], ref, rtol=1e-4, err_msg=key)
    assert trained["tres"]["best_val_acc"] == trained["jres"]["best_val_acc"]

    tt = trained["port"]
    named = {n: p.detach().float().numpy() for n, p in tt.model.named_parameters()}
    got = _flat(flax_tree_from_named_tensors(named, tt.model)["params"])
    ref = _flat(jax.device_get(trained["jax"].state.params))
    assert sorted(got) == sorted(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-5, err_msg=path)
    assert tt.state.step == int(trained["jax"].state.step) == 8

    # the port's run wrote what the JAX run writes
    ckpts = Path(tt.ckpt_dir)
    for name in ("checkpoint_epoch_0", "checkpoint_epoch_1", "best_model"):
        assert (ckpts / name / "model.pt").exists() and (ckpts / f"{name}.meta.json").exists()
    assert (Path(tt.output_dir) / "training_curves.png").exists()


def _state_bits(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def test_resume_equals_uninterrupted(tmp_path):
    cfg = _config(tmp_path, "run")
    cfg["model"]["classifier"]["dropout"] = 0.1  # the dropout streams are resumed too
    full = Trainer(copy.deepcopy(cfg), device="cpu")
    full.setup_data()
    full.setup_model()
    hist = full.train()["history"]
    ckpt = str(Path(full.ckpt_dir) / "checkpoint_epoch_0")

    def resumed(zero_moments: bool):
        other = copy.deepcopy(cfg)
        other["experiment"]["save_dir"] = str(tmp_path / f"resumed_{zero_moments}")
        tr = Trainer(other, device="cpu")
        tr.setup_data()
        tr.setup_model()
        tr.resume(ckpt)
        assert tr.start_epoch == 1 and tr.state.step == 4
        if zero_moments:
            for t in list(tr.state.optimizer.m.values()) + list(tr.state.optimizer.v.values()):
                t.zero_()
        return tr, tr.train()["history"]

    tr, h = resumed(False)
    assert h["train_loss"] == hist["train_loss"][1:] and h["val_acc"] == hist["val_acc"][1:]
    ref = _state_bits(full)
    assert all(torch.equal(p, ref[n]) for n, p in _state_bits(tr).items())
    assert tr.state.optimizer.count == full.state.optimizer.count == 8
    # the control: the same resume without the optimizer's moments
    ctrl, _ = resumed(True)
    assert not all(torch.equal(p, ref[n]) for n, p in _state_bits(ctrl).items())


def test_checkpoint_round_trip_pruning_and_meta(tmp_path):
    cfg = _config(tmp_path, "ckpt")
    cfg["model"]["bf16"] = True  # fp32 masters in the optimizer's state
    cfg["training"]["optimizer"]["factored_threshold"] = 10_000  # a factored leaf too
    model = create_model(cfg, num_classes=4, device="cpu", seed=1)
    state = tstate.create_train_state(model, cfg, 3, device="cpu")
    assert state.optimizer.factored and state.optimizer.master
    rng = torch.Generator().manual_seed(0)
    for _ in range(2):
        state.optimizer.step({n: torch.randn(p.shape, generator=rng).to(p.dtype)
                              for n, p in state.optimizer.params.items()})
        state.step += 1
    ckpt_dir = tmp_path / "ckpts"
    for epoch in range(7):
        tstate.save_checkpoint(str(ckpt_dir), state, epoch, 0.5, cfg, keep=5)
    tstate.save_checkpoint(str(ckpt_dir), state, 6, 0.75, cfg, best=True)
    names = sorted(p.name for p in ckpt_dir.iterdir())
    assert names == sorted([f"checkpoint_epoch_{e}" for e in range(2, 7)]
                           + [f"checkpoint_epoch_{e}.meta.json" for e in range(2, 7)]
                           + ["best_model", "best_model.meta.json"])
    assert tstate.latest_checkpoint_step(str(ckpt_dir)) == 6
    assert tstate.latest_checkpoint_step(str(tmp_path / "none")) is None

    bundle = tstate.restore_checkpoint(str(ckpt_dir / "best_model"), device="cpu")
    assert (bundle["step"], bundle["epoch"], bundle["best_val_acc"]) == (2, 6, 0.75)
    assert bundle["config"] == json.loads(json.dumps(cfg))
    fresh = create_model(cfg, num_classes=4, device="cpu", seed=2)
    fresh_state = tstate.create_train_state(fresh, cfg, 3, device="cpu")
    fresh.load_state_dict(bundle["model"])
    fresh_state.optimizer.load_state_dict(bundle["optimizer"])
    for (n, p), q in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(p, q), n
    mine, theirs = state.optimizer.state_dict(), fresh_state.optimizer.state_dict()
    for key in ("master", "m", "v", "v_row", "v_col", "ema"):
        assert sorted(mine[key]) == sorted(theirs[key]), key
        assert all(torch.equal(t, theirs[key][n]) for n, t in mine[key].items()), key
    assert theirs["count"] == 2
    assert tstate.restore_checkpoint(str(ckpt_dir / "checkpoint_epoch_3"), device="cpu",
                                     optimizer=False)["optimizer"] is None
    with pytest.raises(FileNotFoundError):
        tstate.restore_checkpoint(str(ckpt_dir / "checkpoint_epoch_0"), device="cpu")
    other = tstate.create_optimizer(cfg, 3).init({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="other parameters"):
        other.load_state_dict(bundle["optimizer"])


def test_unported_engine_options_raise(tmp_path):
    cfg = _config(tmp_path, "mesh")
    for mesh in ({"data": 2, "model": 1}, {"data": None, "model": 2}):
        cfg["experiment"]["mesh"] = mesh
        with pytest.raises(NotImplementedError, match="parallelism"):
            Trainer(cfg, device="cpu")
    cfg["experiment"]["mesh"] = {"data": 1, "model": 1}
    cfg["training"]["accumulation_steps"] = 2
    trainer = Trainer(cfg, device="cpu")
    trainer.setup_data()
    with pytest.raises(NotImplementedError, match="gradient accumulation"):
        trainer.setup_model()


def test_evaluator_matches_jax(trained, tmp_path):
    tmp = trained["tmp"]
    best = str(Path(trained["jax"].ckpt_dir) / "best_model")
    je = jevaluator.Evaluator(_config(tmp, "jax_eval"), best)
    jres = je.evaluate(visualize=False, ablation=True)

    # the JAX evaluator's weights, carried to the port through a port checkpoint
    cfg = _config(tmp, "port_eval")
    model = create_model(cfg, num_classes=je.num_classes, device="cpu")
    model.load_state_dict(torch_state_dict_from_flax(jax.device_get(je.variables), model,
                                                     device="cpu"))
    state = tstate.create_train_state(model, cfg, 1, device="cpu")
    tstate.save_checkpoint(str(tmp / "carried"), state, 0, 0.0, cfg, best=True)
    te = Evaluator(cfg, str(tmp / "carried" / "best_model"), device="cpu")
    tres = te.evaluate(visualize=False, ablation=True)

    jm, tm = jres["metrics"], tres["metrics"]
    for key in ("top1_accuracy", "top5_accuracy", "mean_per_class_recall",
                "tta_top1_accuracy", "num_samples"):
        assert tm[key] == jm[key], key
    assert tm["per_class"] == jm["per_class"]
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-4)
    assert tres["ablations"] == jres["ablations"]
    assert sorted(tres["ablations"]) == ["cls_only", "no_gpf", "uniform_graph"]
    ref = je.features["logits"].astype(np.float32)
    assert np.abs(te.features["logits"] - ref).max() <= 1e-4 * np.abs(ref).max()
    np.testing.assert_array_equal(te.features["labels"], je.features["labels"])
    results = json.loads((Path(te.output_dir) / "results.json").read_text())
    assert results["ablations"] == tres["ablations"]

    # the per-sample TTA probabilities, on the first batch
    images, _ = next(iter(te.loader))
    np.testing.assert_allclose(te.predict_tta(images), np.asarray(je.predict_tta(images)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", TTA_SCALES)
def test_tta_views_match_jax_resize(scale):
    aug = jtrainer._augment_config(load_config(str(CFG_PATH)))
    taug_cfg = taug.AugmentConfig(input_size=aug.input_size, resize_size=aug.resize_size)
    images = np.random.default_rng(int(scale * 10)).integers(
        0, 256, (3, aug.resize_size, aug.resize_size, 3), dtype=np.uint8)
    for flip in (False, True):
        # the JAX evaluator's TTA view (train/evaluator.py:196-217)
        imgs = jnp.asarray(images).astype(jnp.float32) / 255.0
        b, s, _, c = imgs.shape
        target = max(aug.input_size, int(round(s * scale)))
        if target != s:
            imgs = jax.image.resize(imgs, (b, target, target, c), method="bilinear")
        off = (imgs.shape[1] - aug.input_size) // 2
        imgs = imgs[:, off:off + aug.input_size, off:off + aug.input_size, :]
        if flip:
            imgs = imgs[:, :, ::-1, :]
        ref = np.asarray((imgs - jnp.asarray(aug.mean)) / jnp.asarray(aug.std))
        got = tta_view(torch.from_numpy(images), taug_cfg, scale, flip).numpy()
        assert got.shape == ref.shape == (3, aug.input_size, aug.input_size, 3)
        assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("cli", [cli_train, cli_eval, cli_predict],
                         ids=["train", "eval", "predict"])
def test_cli_help(cli, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--config" in out and "{cuda,cpu}" in out


def test_cli_train_one_epoch_on_the_smoke_config(tmp_path, capsys):
    import yaml

    cfg = _config(tmp_path, "cli", parity=False)
    path = tmp_path / "smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert cli_train.main(["--config", str(path), "--epochs", "1", "--device", "cpu"]) == 0
    assert "best val accuracy" in capsys.readouterr().out
    ckpts = Path(cfg["experiment"]["save_dir"])
    assert (ckpts / "checkpoint_epoch_0" / "model.pt").exists()
    meta = json.loads((ckpts / "checkpoint_epoch_0.meta.json").read_text())
    assert meta["epoch"] == 0 and meta["step"] == 4
    assert meta["config"]["model"]["backbone_name"] == "vit_tiny_patch16_224"
    assert cli_predict.main(["--config", str(path), "--checkpoint",
                             str(ckpts / "checkpoint_epoch_0"), "--device", "cpu",
                             "--dataset-split", "test", "--limit", "2"]) == 0
    assert capsys.readouterr().out.count("test[") == 2
