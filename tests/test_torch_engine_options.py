"""The slice as a whole: the head and training options through the port's
Trainer and Evaluator against the JAX package's, on the CPU in fp32.

``configs/smoke_synthetic.yaml`` with the backbone cut to
``swin_micro_patch4_window7_56`` (input 56, resize 64) and this slice's
options switched on together: ``gpf.adaptive_type: attention``, ``norm:
batch``, ``classifier.type: adaptive`` and ``training.accumulation_steps:
2``; dropout 0 and AdamW's eps 1e-6, as ``tests/test_torch_engine.py`` has
them and for its reasons.  Both trainers start from the JAX trainer's initial
variables (parameters, BatchNorm statistics and sketch matrices, carried by
``torch_state_dict_from_flax``) and get the same views (the augmentation
patched on both sides to the eval views, the positive view mirrored).

* One epoch (4 micro-steps, 2 updates): every micro-step's loss within 1e-4
  relative, the epoch's train and val loss and every loss term within 1e-4
  relative, accuracies equal, final parameters within 1e-5 absolute per leaf
  (the four biases that feed a BatchNorm aside: their gradient is zero in
  exact arithmetic, so AdamW turns rounding noise into steps of up to lr
  with a random sign on both sides; each is held within two such steps of
  where it started) and the BatchNorm running statistics within 1e-5 of
  their scale (a variance's largest entry, a mean's features' spread: the
  square root of that) (they moved on every micro-step, updates or not).
* The Evaluator on the JAX evaluator's weights (its ``best_model``), carried
  to the port through a port checkpoint: the metrics, per-class report and
  ablations equal, the logits within 1e-4 of max |logit| (eval mode reads the
  running statistics).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ego_moment_cle_vit_tpu.data import augment as jaug
from ego_moment_cle_vit_tpu.train import evaluator as jevaluator
from ego_moment_cle_vit_tpu.train import trainer as jtrainer
from ego_moment_cle_vit_tpu.utils import load_config
from ego_moment_cle_vit_tpu_torch import create_model
from ego_moment_cle_vit_tpu_torch.data import augment as taug
from ego_moment_cle_vit_tpu_torch.train import Evaluator, Trainer
from ego_moment_cle_vit_tpu_torch.train import state as tstate
from ego_moment_cle_vit_tpu_torch.train import step as tstep
from ego_moment_cle_vit_tpu_torch.utils.convert import (
    flax_tree_from_named_tensors,
    torch_state_dict_from_flax,
)

torch.set_num_threads(1)

CFG_PATH = Path(__file__).resolve().parent.parent / "configs" / "smoke_synthetic.yaml"
# Dense biases a BatchNorm follows in training mode: zero gradient in exact arithmetic
AHEAD_OF_A_NORM = {"moment_head/second_proj/bias", "moment_head/third_proj/bias",
                   "classifier/fc1/bias", "classifier/fc2/bias"}


def _config(tmp: Path, tag: str) -> dict:
    cfg = load_config(str(CFG_PATH))
    for key in ("output_dir", "save_dir", "log_dir"):
        cfg["experiment"][key] = str(tmp / tag / key)
    cfg["model"]["backbone_name"] = "swin_micro_patch4_window7_56"
    cfg["model"]["norm"] = "batch"
    cfg["model"]["gpf"]["adaptive_type"] = "attention"
    cfg["model"]["classifier"].update(type="adaptive", dropout=0.0)
    cfg["data"].update(input_size=56, resize_size=64)
    cfg["training"].update(epochs=1, accumulation_steps=2)
    cfg["training"]["optimizer"]["eps"] = 1e-6
    cfg["evaluation"]["tta"] = {"enabled": False}
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


def _recording(step, losses):
    def recorded(*args):
        metrics = step(*args)
        out = metrics[1] if isinstance(metrics, tuple) else metrics
        losses.append(float(out["loss"]))
        return metrics
    return recorded


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine_options")
    losses = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "dual_view_train_batch", _jax_views)
        mp.setattr(tstep, "dual_view_train_batch", _port_views)
        jt = jtrainer.Trainer(_config(tmp, "jax"))
        jt.setup_data()
        jt.setup_model()
        jt._train_step = _recording(jt._train_step, losses["jax"])
        tt = Trainer(_config(tmp, "port"), device="cpu")
        tt.setup_data()
        tt.setup_model()
        tt._train_step = _recording(tt._train_step, losses["port"])
        variables = {"params": jax.device_get(jt.state.params),
                     "batch_stats": jax.device_get(jt.state.batch_stats),
                     "constants": jax.device_get(jt.state.constants)}
        tt.model.load_state_dict(torch_state_dict_from_flax(variables, tt.model, device="cpu"))
        jres = jt.train()
        tres = tt.train()
    return {"tmp": tmp, "jax": jt, "port": tt, "jres": jres, "tres": tres, "losses": losses,
            "initial": variables}


def test_trainer_with_the_options_matches_jax(trained):
    tt, jt = trained["port"], trained["jax"]
    assert tt.state.optimizer.accumulation_steps == 2
    np.testing.assert_allclose(trained["losses"]["port"], trained["losses"]["jax"], rtol=1e-4)
    assert len(trained["losses"]["port"]) == 4
    jh, th = trained["jres"]["history"], trained["tres"]["history"]
    assert sorted(th) == sorted(jh)
    for key, ref in jh.items():
        if key in ("train_acc", "val_acc"):
            assert th[key] == [float(v) for v in ref], key
        elif key == "lr":
            np.testing.assert_allclose(th[key], ref, rtol=1e-6)
        else:
            np.testing.assert_allclose(th[key], ref, rtol=1e-4, err_msg=key)

    named = {n: p.detach().numpy() for n, p in tt.model.named_parameters()}
    got = _flat(flax_tree_from_named_tensors(named, tt.model)["params"])
    ref = _flat(jax.device_get(jt.state.params))
    assert sorted(got) == sorted(ref)
    assert "gpf/coeff_mod/kernel" in ref and "classifier/se_fc1/kernel" in ref
    start = _flat(trained["initial"]["params"])
    lr = tt.config["training"]["optimizer"]["lr"]
    for path, r in ref.items():
        if path in AHEAD_OF_A_NORM:
            for side in (got[path], r):
                assert np.abs(side - start[path]).max() <= 2 * lr, path
        else:
            np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-5, err_msg=path)

    buffers = {n: b.numpy() for n, b in tt.model.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    got = _flat(flax_tree_from_named_tensors(buffers, tt.model)["batch_stats"])
    ref = _flat(jax.device_get(jt.state.batch_stats))
    before = _flat(trained["initial"]["batch_stats"])
    assert sorted(got) == sorted(ref) and len(ref) == 8  # 4 BatchNorms x (mean, var)
    for path, r in ref.items():
        assert not np.allclose(r, before[path]), path  # the statistics moved
        # a mean at the size of its features' spread, sqrt(var)
        scale = np.sqrt(ref[path[:-len("mean")] + "var"].max()) if path.endswith("mean") \
            else np.abs(r).max()
        np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-5 * scale, err_msg=path)
    assert tt.state.step == int(jt.state.step) == 4
    assert tt.state.optimizer.count == 2


def test_evaluator_with_the_options_matches_jax(trained):
    tmp = trained["tmp"]
    best = str(Path(trained["jax"].ckpt_dir) / "best_model")
    je = jevaluator.Evaluator(_config(tmp, "jax_eval"), best)
    jres = je.evaluate(visualize=False, ablation=True)

    cfg = _config(tmp, "port_eval")
    model = create_model(cfg, num_classes=je.num_classes, device="cpu")
    assert "batch_stats" in je.variables
    model.load_state_dict(torch_state_dict_from_flax(jax.device_get(je.variables), model,
                                                     device="cpu"))
    state = tstate.create_train_state(model, cfg, 1, device="cpu")
    tstate.save_checkpoint(str(tmp / "carried"), state, 0, 0.0, cfg, best=True)
    te = Evaluator(cfg, str(tmp / "carried" / "best_model"), device="cpu")
    tres = te.evaluate(visualize=False, ablation=True)

    jm, tm = jres["metrics"], tres["metrics"]
    for key in ("top1_accuracy", "top5_accuracy", "mean_per_class_recall", "num_samples"):
        assert tm[key] == jm[key], key
    assert tm["per_class"] == jm["per_class"]
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-4)
    assert tres["ablations"] == jres["ablations"]
    ref = je.features["logits"].astype(np.float32)
    assert np.abs(te.features["logits"] - ref).max() <= 1e-4 * np.abs(ref).max()
