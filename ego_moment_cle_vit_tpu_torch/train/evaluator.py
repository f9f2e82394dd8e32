"""Evaluator engine.

The port's counterpart of ``ego_moment_cle_vit_tpu/train/evaluator.py``:
top-1 / top-5 accuracy, macro mean per-class recall and the per-class report,
the collected features, the visualization suite, ``results.json`` (and
``predictions.npz`` / ``features.npz`` when asked for), the three ablations
and test-time augmentation (TTA).

Every forward runs in eval mode under ``torch.inference_mode()``, as serving
does (``serve.py``).  TTA resizes with the weights of ``jax.image.resize``
(``ops/resize.py``), so its views are the JAX evaluator's.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data import BatchLoader, DevicePrefetcher, dual_view_eval_batch
from ..models import create_model
from ..ops.resize import resize
from ..utils.device import resolve_device
from .state import restore_checkpoint
from .trainer import _augment_config, _make_dataset


def classification_metrics(labels: np.ndarray, logits: np.ndarray, class_names) -> Dict[str, Any]:
    """top1/top5, macro per-class recall, per-class report."""
    preds = logits.argmax(-1)
    top1 = float((preds == labels).mean())
    k = min(5, logits.shape[-1])
    topk = np.argsort(-logits, axis=-1)[:, :k]
    top5 = float((topk == labels[:, None]).any(-1).mean())

    per_class = {}
    recalls = []
    for ci, cname in enumerate(class_names):
        mask = labels == ci
        support = int(mask.sum())
        if support == 0:
            continue
        recall = float((preds[mask] == ci).mean())
        pred_mask = preds == ci
        precision = float((labels[pred_mask] == ci).mean()) if pred_mask.any() else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
        per_class[cname] = {"precision": precision, "recall": recall, "f1": f1,
                            "support": support}
        recalls.append(recall)
    return {
        "top1_accuracy": top1,
        "top5_accuracy": top5,
        "mean_per_class_recall": float(np.mean(recalls)) if recalls else 0.0,
        "per_class": per_class,
    }


def tta_view(images_u8: torch.Tensor, aug_cfg, scale: float, flip: bool) -> torch.Tensor:
    """One TTA view: uint8 [B, S, S, 3] -> /255, bilinear resize to
    ``max(input_size, round(S * scale))`` (antialiased when it shrinks),
    center crop to ``input_size``, optional horizontal flip, normalize."""
    imgs = images_u8.float() / 255.0
    b, s, _, c = imgs.shape
    target = max(aug_cfg.input_size, int(round(s * scale)))
    if target != s:
        imgs = resize(imgs, (b, target, target, c), "bilinear")
    off = (imgs.shape[1] - aug_cfg.input_size) // 2
    imgs = imgs[:, off:off + aug_cfg.input_size, off:off + aug_cfg.input_size, :]
    if flip:
        imgs = imgs.flip(2)
    mean = torch.tensor(aug_cfg.mean, dtype=imgs.dtype, device=imgs.device)
    std = torch.tensor(aug_cfg.std, dtype=imgs.dtype, device=imgs.device)
    return (imgs - mean) / std


class Evaluator:
    """``Evaluator(config, checkpoint_path).evaluate()`` -> results dict.

    Runs on the GPU unless ``device='cpu'``; raises without one."""

    def __init__(self, config: Dict[str, Any], checkpoint_path: Optional[str] = None, *,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        exp = config.get("experiment", {})
        self.output_dir = Path(exp.get("output_dir", "./outputs")) / "evaluation"
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.aug_cfg = _augment_config(config)
        self.model: Optional[torch.nn.Module] = None

    def setup_data(self) -> None:
        try:
            self.dataset = _make_dataset(self.config, "test")
        except ValueError as e:
            # only a missing split falls back to val; a config error (a
            # misspelt dataset name) surfaces as it is
            if "split" not in str(e).lower():
                raise
            print("No test split found; falling back to val")
            self.dataset = _make_dataset(self.config, "val")
        batch = int(self.config.get("training", {}).get("batch_size", 64))
        self.loader = BatchLoader(self.dataset, batch_size=batch, shuffle=False, drop_last=False,
                                  num_workers=int(self.config.get("data", {}).get("num_workers",
                                                                                  8)))
        self.num_classes = len(self.dataset.classes)

    def load_model(self) -> None:
        if self.checkpoint_path is not None:
            bundle = restore_checkpoint(self.checkpoint_path, device=self.device,
                                        optimizer=False)
            # the checkpoint's model config fills what this config leaves out
            ckpt_cfg = bundle.get("config") or {}
            for key, val in ckpt_cfg.get("model", {}).items():
                self.config.setdefault("model", {}).setdefault(key, val)
            self.model = create_model(self.config, self.num_classes, device=self.device)
            self.model.load_state_dict(bundle["model"])
        else:
            # fresh weights (smoke evaluation)
            self.model = create_model(self.config, self.num_classes, device=self.device, seed=0)
        self.model.eval()
        self._build_steps()

    def _build_steps(self) -> None:
        model, aug_cfg, dev = self.model, self.aug_cfg, self.device

        def eval_views(images_u8):
            return dual_view_eval_batch(images_u8.to(dev, non_blocking=True), aug_cfg)

        def eval_step(images_u8, labels):
            with torch.inference_mode():
                anchor, positive = eval_views(images_u8)
                out = model(anchor, positive, labels.to(dev), return_features=True)
                feats = out["features"]
                return {"logits": out["logits"], "loss": out["loss"],
                        "moment_features": feats["moment_features"],
                        "anchor_global": feats["anchor_global"],
                        "fused_graph": feats["fused_graph"]}

        def make_ablation(mode: str):
            def step(images_u8):
                with torch.inference_mode():
                    anchor, positive = eval_views(images_u8)
                    return model.ablation_forward(anchor, positive, mode)

            return step

        self._eval_step = eval_step
        self._ablation_steps = {mode: make_ablation(mode)
                                for mode in ("no_gpf", "uniform_graph", "cls_only")}

        # test-time augmentation (evaluation.tta): the scales, then a
        # horizontal flip at scale 1
        tta_cfg = self.config.get("evaluation", {}).get("tta", {}) or {}
        self._tta_enabled = bool(tta_cfg.get("enabled", False))
        scales = tuple(float(s) for s in tta_cfg.get("scales", (0.9, 1.0, 1.1)))

        def make_tta(scale: float, flip: bool):
            def step(images_u8):
                with torch.inference_mode():
                    view = tta_view(images_u8.to(dev, non_blocking=True), aug_cfg, scale, flip)
                    return torch.softmax(model.inference(view).float(), dim=-1)

            return step

        self._tta_steps: List[Callable] = []
        if self._tta_enabled:
            self._tta_steps = [make_tta(s, False) for s in scales]
            self._tta_steps.append(make_tta(1.0, True))

    def predict_tta(self, images_u8) -> np.ndarray:
        """Averaged softmax over the TTA views (scales + horizontal flip)."""
        images = torch.as_tensor(images_u8)
        probs = None
        for step in self._tta_steps:
            p = step(images).cpu().numpy()
            probs = p if probs is None else probs + p
        return probs / len(self._tta_steps)

    # -- passes ----------------------------------------------------------------

    def compute_metrics(self) -> Dict[str, Any]:
        all_logits, all_labels, all_moment, all_global, losses = [], [], [], [], []
        t0 = time.perf_counter()
        n_images = 0
        sample_graph = None
        for images, labels in DevicePrefetcher(self.loader, self.device):
            out = self._eval_step(images, labels)
            if sample_graph is None:
                # one fused graph for the visualization suite, from the first batch
                sample_graph = out["fused_graph"][0].float().cpu().numpy()
            all_logits.append(out["logits"].float().cpu().numpy())
            all_labels.append(labels.cpu().numpy())
            all_moment.append(out["moment_features"].float().cpu().numpy())
            all_global.append(out["anchor_global"].float().cpu().numpy())
            losses.append(out["loss"].item())
            n_images += labels.shape[0]
        elapsed = time.perf_counter() - t0

        logits = np.concatenate(all_logits)
        labels = np.concatenate(all_labels)
        self.features = {
            "moment": np.concatenate(all_moment),
            "global": np.concatenate(all_global),
            "labels": labels,
            "logits": logits,
            "sample_graph": sample_graph,
        }
        metrics = classification_metrics(labels, logits, self.dataset.classes)
        metrics["loss"] = float(np.mean(losses))
        metrics["images_per_sec"] = n_images / max(elapsed, 1e-9)
        metrics["num_samples"] = int(labels.shape[0])

        if self._tta_enabled:
            tta_probs, tta_labels = [], []
            for images, lab in self.loader:
                tta_probs.append(self.predict_tta(images))
                tta_labels.append(lab)
            probs = np.concatenate(tta_probs)
            metrics["tta_top1_accuracy"] = float(
                (probs.argmax(-1) == np.concatenate(tta_labels)).mean())
        return metrics

    def run_ablation_study(self) -> Dict[str, float]:
        """Accuracy of each ablation (``ablation.enabled``, on by default)."""
        if not self.config.get("ablation", {}).get("enabled", True):
            return {}
        results = {}
        for mode, step in self._ablation_steps.items():
            correct = total = 0
            for images, labels in DevicePrefetcher(self.loader, self.device):
                preds = step(images).argmax(-1)
                correct += int((preds == labels.to(preds.device)).sum())
                total += labels.shape[0]
            results[mode] = correct / max(total, 1)
        return results

    def generate_visualizations(self) -> None:
        from ..utils import viz

        try:
            labels = self.features["labels"]
            logits = self.features["logits"]
            viz.plot_confusion_matrix(labels, logits.argmax(-1), class_names=self.dataset.classes,
                                      save_path=str(self.output_dir / "confusion_matrix.png"))
            viz.plot_feature_embeddings(self.features["moment"], labels, method="pca",
                                        save_path=str(self.output_dir / "moment_embeddings.png"))
            viz.plot_feature_embeddings(self.features["global"], labels, method="pca",
                                        save_path=str(self.output_dir / "global_embeddings.png"))
            coeffs = self.model.gpf.coefficient_matrix().detach().float().cpu().numpy()
            viz.plot_polynomial_coefficients(
                coeffs, save_path=str(self.output_dir / "gpf_coefficients.png"))
            if self.features.get("sample_graph") is not None:
                viz.plot_graph_weights(self.features["sample_graph"],
                                       save_path=str(self.output_dir / "graph_weights.png"))
            viz.visualize_moment_features(self.features["moment"], labels,
                                          save_path=str(self.output_dir / "moment_analysis.png"))
        except ImportError as exc:  # matplotlib is optional
            print(f"visualization skipped: {exc}")

    def save_results(self, metrics: Dict[str, Any], ablations: Dict[str, float]) -> str:
        payload = {
            "dataset": self.dataset.dataset_name,
            "checkpoint": self.checkpoint_path,
            "metrics": {k: v for k, v in metrics.items() if k != "per_class"},
            "per_class": metrics.get("per_class", {}),
            "ablations": ablations,
        }
        path = self.output_dir / "results.json"
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)

        ecfg = self.config.get("evaluation", {})
        if ecfg.get("save_predictions"):
            np.savez_compressed(self.output_dir / "predictions.npz",
                                logits=self.features["logits"], labels=self.features["labels"],
                                predictions=self.features["logits"].argmax(-1))
        if ecfg.get("save_features"):
            np.savez_compressed(self.output_dir / "features.npz",
                                moment=self.features["moment"],
                                global_features=self.features["global"],
                                labels=self.features["labels"])
        return str(path)

    def evaluate(self, visualize: bool = True, ablation: bool = True) -> Dict[str, Any]:
        self.setup_data()
        self.load_model()
        metrics = self.compute_metrics()
        print(f"top1={metrics['top1_accuracy']:.4f} top5={metrics['top5_accuracy']:.4f} "
              f"mean_recall={metrics['mean_per_class_recall']:.4f} "
              f"({metrics['images_per_sec']:.1f} img/s)")
        ablations = self.run_ablation_study() if ablation else {}
        if ablations:
            print("ablations:", {k: f"{v:.4f}" for k, v in ablations.items()})
        if visualize:
            self.generate_visualizations()
        path = self.save_results(metrics, ablations)
        print(f"results saved to {path}")
        return {"metrics": metrics, "ablations": ablations}
