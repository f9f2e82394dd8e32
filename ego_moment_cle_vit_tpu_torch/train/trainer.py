"""Trainer engine.

The port's counterpart of ``ego_moment_cle_vit_tpu/train/trainer.py:98-613``:
logging, seeding and directories, data and model setup, the epoch loop with
its validation and checkpoint cadence, the learning-rate history, resume.

* One step (``train/step.py``) holds the on-device dual-view augmentation,
  the dual-view forward, the loss, backward and the optimizer update; the
  host feeds uint8 batches and reads the metrics, summed on the device, once
  an epoch.
* Data: a split that fits the budget is kept on the device
  (``DeviceDatasetCache``); otherwise it is decoded once into host RAM
  (``HostDecodedCache``) where that fits, and streamed by ``BatchLoader``
  through ``DevicePrefetcher``.
* Scale-out is the config's ``experiment.mesh``, a ('data', 'model') mesh
  (``parallel/``): one process per rank, started by ``torchrun`` (rank and
  world size from its environment) or inside an existing process group.
  Each data rank loads and steps on its rows of every batch, the moment
  head's and classifier's big projections shard their fan-in over 'model',
  and a step computes what the one-device step computes on the global batch.
  Rank 0 alone logs, writes checkpoints (the one-device format) and plots.
  A process that is not part of a world, with a mesh of one device, runs the
  one-device path; a mesh that does not match the world raises.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..data import (
    AugmentConfig,
    BatchLoader,
    DeviceDatasetCache,
    DevicePrefetcher,
    HostDecodedCache,
    SyntheticUFGDataset,
    UFGVCDataset,
    device_cache_fits,
    host_cache_fits,
)
from ..models import create_model
from ..parallel import create_mesh, load_params, mesh_shape, replicate, shard_params
from ..utils.device import resolve_device
from ..utils.ops import get_model_info, set_seed
from .state import (
    TrainState,
    create_learning_rate_schedule,
    create_train_state,
    restore_checkpoint,
    save_checkpoint,
)
from .step import make_eval_step, make_train_step


def _make_dataset(config: Dict[str, Any], split: str):
    dcfg = config.get("dataset", {})
    data = config.get("data", {})
    resize = int(data.get("resize_size", 600))
    name = dcfg.get("name", "cotton80")
    if name == "synthetic" or dcfg.get("synthetic", False):
        return SyntheticUFGDataset(
            num_classes=int(dcfg.get("num_classes", 80)),
            samples_per_class=int(dcfg.get("samples_per_class", 9)),
            image_size=resize,
            split=split,
            seed=int(config.get("experiment", {}).get("seed", 42)),
            learnable=bool(dcfg.get("learnable", False)),
        )
    return UFGVCDataset(
        dataset_name=name,
        root=dcfg.get("root", "./data"),
        split=split,
        resize_size=resize,
        download=bool(dcfg.get("download", True)),
    )


def _augment_config(config: Dict[str, Any]) -> AugmentConfig:
    data = config.get("data", {})
    jitter = data.get("color_jitter", {}) or {}
    return AugmentConfig(
        input_size=int(data.get("input_size", 448)),
        resize_size=int(data.get("resize_size", 600)),
        hflip_prob=float(data.get("horizontal_flip", 0.5)),
        brightness=float(jitter.get("brightness", 0.2)),
        contrast=float(jitter.get("contrast", 0.2)),
        saturation=float(jitter.get("saturation", 0.2)),
        hue=float(jitter.get("hue", 0.1)),
        rotation_degrees=float(data.get("rotation", 10.0)),
        mask_ratio=tuple(data.get("mask_ratio", (0.15, 0.45))),
        grid_size=int(data.get("grid_size", 4)),
        mean=tuple(data.get("mean", (0.485, 0.456, 0.406))),
        std=tuple(data.get("std", (0.229, 0.224, 0.225))),
    )


class Trainer:
    """Config-driven training engine:
    ``Trainer(config).setup_data(); setup_model(); train()``.

    Runs on the GPU unless ``device='cpu'``; raises without one.  On a mesh
    (``experiment.mesh``, one process per rank) a GPU rank takes
    ``cuda:{LOCAL_RANK}`` and a CPU rank talks over gloo; ``mesh`` hands the
    trainer a mesh built by the caller instead (``parallel.create_mesh``, e.g.
    several ranks on one card), which must have the config's shape."""

    def __init__(self, config: Dict[str, Any], *, device: str | torch.device = "cuda",
                 mesh=None):
        self.config = config
        self.device = resolve_device(device)
        exp = config.get("experiment", {})
        mesh_cfg = exp.get("mesh") or {}
        if mesh is None:
            self.mesh = self._setup_mesh(mesh_cfg)
        elif mesh_shape(mesh_cfg.get("data"), mesh_cfg.get("model", 1) or 1,
                        mesh.size) != (mesh.data, mesh.model):
            raise ValueError(f"the mesh is {mesh.data}x{mesh.model}, the config's "
                             f"experiment.mesh is {mesh_cfg}")
        else:
            self.mesh = mesh
        if self.mesh is not None:
            self.device = self.mesh.device
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.exp_name = exp.get("name", "ego_moment_clevit")
        self.output_dir = Path(exp.get("output_dir", "./outputs"))
        self.ckpt_dir = Path(exp.get("save_dir", "./checkpoints"))
        self.log_dir = Path(exp.get("log_dir", "./logs"))
        for d in (self.output_dir, self.ckpt_dir, self.log_dir):
            d.mkdir(parents=True, exist_ok=True)

        self.logger = self._setup_logging()
        self.seed = int(exp.get("seed", 42))
        # the model's initial weights and the steps' random streams, both
        # drawn from the run's seed
        root = set_seed(self.seed)
        self.init_seed, train_seed = (
            int(s) for s in torch.randint(0, 2**62, (2,), generator=root))
        self.train_generator = torch.Generator().manual_seed(train_seed)
        self.aug_cfg = _augment_config(config)
        self.logger.info("device=%s", self.device)
        if self.mesh is not None:
            self.logger.info("mesh data=%d model=%d (rank %d of %d)", self.mesh.data,
                             self.mesh.model, self.mesh.rank, self.mesh.size)

        self.wandb_run = self._setup_wandb()
        self.state: Optional[TrainState] = None
        self.best_val_acc = 0.0
        self.start_epoch = 0
        self.history: Dict[str, list] = {
            "train_loss": [],
            "train_acc": [],
            "val_loss": [],
            "val_acc": [],
            "lr": [],
        }

    # -- setup ---------------------------------------------------------------

    def _setup_mesh(self, mesh_cfg: Dict[str, Any]):
        """The config's mesh over the process group (joined from ``torchrun``'s
        environment if the process has none), or None for one device outside
        a world."""
        data, model = mesh_cfg.get("data"), int(mesh_cfg.get("model", 1) or 1)
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        if world == 1 and not dist.is_initialized():
            mesh_shape(data, model, 1)  # raises for a mesh above one device
            return None
        devices = ["cpu"] * world if self.device.type == "cpu" else None
        return create_mesh(data, model, devices)

    def _setup_logging(self) -> logging.Logger:
        logger = logging.getLogger(f"emct_torch.{self.exp_name}")
        logger.setLevel(logging.INFO)
        if self.rank != 0:  # rank 0 alone logs
            logger.disabled = True
            return logger
        if not logger.handlers:
            fh = logging.FileHandler(self.log_dir / f"{self.exp_name}.log")
            ch = logging.StreamHandler()
            fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            fh.setFormatter(fmt)
            ch.setFormatter(fmt)
            logger.addHandler(fh)
            logger.addHandler(ch)
        return logger

    def _setup_wandb(self):
        wcfg = self.config.get("experiment", {}).get("wandb", {})
        if not wcfg.get("enabled", False) or self.rank != 0:
            return None
        try:
            import wandb
        except ImportError as exc:
            self.logger.warning("wandb unavailable: %s", exc)
            return None
        return wandb.init(project=wcfg.get("project", "ego-moment-clevit"),
                          entity=wcfg.get("entity"), name=self.exp_name, config=self.config)

    def setup_data(self) -> None:
        tcfg = self.config.get("training", {})
        batch_size = int(tcfg.get("batch_size", 64))
        self.train_dataset = _make_dataset(self.config, "train")
        try:
            self.val_dataset = _make_dataset(self.config, "val")
        except ValueError:
            self.logger.warning("no val split; falling back to test")
            self.val_dataset = _make_dataset(self.config, "test")

        dcfg = self.config.get("data", {})
        workers = int(dcfg.get("num_workers", 8))
        # batches staged onto the device ahead of the step; 0 copies inline
        self._device_prefetch = int(dcfg.get("device_prefetch", 2))
        # with drop_last, a val split smaller than the train batch would give
        # no val batch at all, and best_val_acc would never move
        val_batch = max(1, min(batch_size, len(self.val_dataset)))

        # data.device_cache: auto|true|false keeps a split resident on the
        # device (auto: when it fits device_cache_budget_gb); data.host_cache
        # decodes a split that misses it once into host RAM
        cache_mode = str(dcfg.get("device_cache", "auto")).lower()
        budget = int(float(dcfg.get("device_cache_budget_gb", 6.0)) * 1024**3)
        host_cache_mode = str(dcfg.get("host_cache", "auto")).lower()
        host_budget = int(float(dcfg.get("host_cache_budget_gb", 16.0)) * 1024**3)
        worker_type = str(dcfg.get("worker_type", "thread"))

        def make_loader(dataset, bsz, shuffle):
            img_size = getattr(dataset, "image_size", None) or int(dcfg.get("resize_size", 600))
            fits = device_cache_fits(len(dataset), img_size, budget)
            if cache_mode == "true" or (cache_mode == "auto" and fits):
                if not fits:
                    self.logger.warning(
                        "device_cache=true but split (%d x %d^2) exceeds the %d GB budget; "
                        "caching anyway as requested", len(dataset), img_size, budget // 1024**3)
                # on a mesh: the split on every rank's device, its rows gathered
                loader = DeviceDatasetCache(dataset, batch_size=bsz, shuffle=shuffle,
                                            seed=self.seed, num_workers=workers,
                                            mesh=self.mesh, device=self.device)
                self.logger.info("device cache: %d samples (%.0f MB) resident on %s",
                                 len(dataset), loader.nbytes / 1e6, self.device)
                return loader
            host_fits = host_cache_fits(len(dataset), img_size, host_budget)
            if host_cache_mode == "true" or (host_cache_mode == "auto" and host_fits):
                dataset = HostDecodedCache(dataset, num_workers=workers, worker_type="process")
                self.logger.info("host decoded cache: %d samples (%.0f MB) in RAM",
                                 len(dataset), dataset.nbytes / 1e6)
            # on a mesh each data rank loads (and decodes) its rows of each batch
            shard = None if self.mesh is None else (self.mesh.data_index, self.mesh.data)
            return BatchLoader(dataset, batch_size=bsz, shuffle=shuffle, seed=self.seed,
                               num_workers=workers, worker_type=worker_type, data_shard=shard)

        self.train_loader = make_loader(self.train_dataset, batch_size, True)
        self.val_loader = make_loader(self.val_dataset, val_batch, False)
        self.num_classes = len(self.train_dataset.classes)
        self.config.setdefault("model", {})["num_classes"] = self.num_classes
        self.logger.info("data: train=%d val=%d classes=%d batch=%d", len(self.train_dataset),
                         len(self.val_dataset), self.num_classes, batch_size)

    def setup_model(self) -> None:
        self.model = create_model(self.config, self.num_classes, device=self.device,
                                  seed=self.init_seed)

        # pretrained backbone splice: a timm state_dict file (utils/port_weights.py)
        mcfg = self.config.get("model", {})
        ckpt = mcfg.get("timm_checkpoint")
        if mcfg.get("pretrained") and ckpt:
            from ..utils.port_weights import load_torch_backbone, splice_backbone_params

            name = mcfg.get("backbone_name", "")
            family = "swin" if name.startswith("swin") else "vit"
            self.model.load_state_dict(splice_backbone_params(
                self.model.state_dict(), load_torch_backbone(name, ckpt), family))
            self.logger.info("loaded pretrained backbone from %s", ckpt)
        elif mcfg.get("pretrained"):
            self.logger.warning("model.pretrained=true but no model.timm_checkpoint path "
                                "given; training from scratch")
        if self.mesh is not None:
            # rank 0's weights everywhere, then the big projections' fan-in
            # sharded over the model axis
            replicate(self.model, self.mesh)
            shard_params(self.model, self.mesh)

        steps_per_epoch = max(len(self.train_loader), 1)
        self.state = create_train_state(self.model, self.config, steps_per_epoch,
                                        device=self.device, mesh=self.mesh)
        # the host's copy of the schedule, for the logs and the lr history
        self.lr_schedule = create_learning_rate_schedule(self.config, steps_per_epoch)
        # the schedule runs on the optimizer-update clock; state.step counts
        # micro-batches
        self._lr_accum = max(int(self.config.get("training", {}).get("accumulation_steps", 1)),
                             1)
        info = get_model_info(self.model)
        self.logger.info("model: %s params=%s (%.1f MB fp32)", mcfg.get("backbone_name"),
                         f"{info['total_parameters']:,}", info["parameter_memory_mb"])
        self._train_step = make_train_step(self.model, self.aug_cfg, device=self.device,
                                           metrics=True, mesh=self.mesh)
        self._eval_step = make_eval_step(self.model, self.aug_cfg, device=self.device,
                                         mesh=self.mesh)

    def resume(self, ckpt_path: str) -> None:
        bundle = restore_checkpoint(ckpt_path, device=self.device)
        load_params(self.model, bundle["model"], self.mesh)
        self.state.optimizer.load_state_dict(bundle["optimizer"])
        self.state.step = int(bundle["step"])
        self.start_epoch = int(bundle["epoch"]) + 1
        self.best_val_acc = float(bundle.get("best_val_acc", 0.0))
        self.logger.info("resumed from %s at epoch %d (best %.4f)", ckpt_path, self.start_epoch,
                         self.best_val_acc)

    # -- loops ----------------------------------------------------------------

    def _device_batches(self, loader):
        """Device-resident batches (on a mesh, the loaders already give this
        rank's rows); data.device_prefetch=0 copies each batch inline."""
        if isinstance(loader, DeviceDatasetCache):
            return iter(loader)
        if self._device_prefetch > 0:
            return DevicePrefetcher(loader, self.device, depth=self._device_prefetch)
        return ((torch.from_numpy(images).to(self.device), torch.from_numpy(labels).to(
            self.device)) for images, labels in loader)

    def _stop_profile(self, prof) -> None:
        prof.stop()
        out = self.log_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        sort = "cuda_time_total" if self.device.type == "cuda" else "cpu_time_total"
        (out / "key_averages.txt").write_text(
            prof.key_averages().table(sort_by=sort, row_limit=60))
        self.logger.info("profiler trace written to %s", out)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        exp = self.config.get("experiment", {})
        log_freq = int(exp.get("log_frequency", 100))
        # experiment.profile_steps: a torch.profiler trace of the first N
        # steps of the first epoch run, into log_dir/profile (trace.json and
        # key_averages.txt).  It holds the port's spans (utils/trace.py), so
        # rows named emct.* split a step by phase: emct.train.step around
        # each step, inside it emct.train.augment / .forward (emct.backbone,
        # emct.gpf, emct.moment_head, emct.classifier, emct.train.loss) /
        # .backward / .grad_sum (on a mesh) / .update (emct.train.host_read,
        # the gradient norm's read), emct.kernel.<wrapper> around each
        # hand-written kernel's launch, and emct.data.wait where the step
        # waited for its batch
        profile_steps = int(exp.get("profile_steps", 0))
        prof = None
        if profile_steps > 0 and epoch == self.start_epoch and self.rank == 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        keys, totals = None, None
        count = 0
        images_seen = 0
        t0 = time.perf_counter()
        for i, (images, labels) in enumerate(self._device_batches(self.train_loader)):
            if prof is not None and i == profile_steps:
                self._stop_profile(prof)
                prof = None
            metrics = self._train_step(self.state, images, labels, self.train_generator)
            count += 1
            images_seen += labels.shape[0] * (1 if self.mesh is None else self.mesh.data)
            # summed on the device: a host read per step would wait for it
            step_values = torch.stack([metrics[k] for k in (keys or metrics)])
            if totals is None:
                keys, totals = list(metrics), step_values
            else:
                totals = totals + step_values
            if (i + 1) % log_freq == 0:
                loss, acc = (totals[:2] / count).tolist()
                lr = self.lr_schedule(self.state.step // self._lr_accum)
                self.logger.info("epoch %d step %d loss=%.4f acc=%.4f lr=%.2e", epoch, i + 1,
                                 loss, acc, lr)
                if self.wandb_run is not None:
                    self.wandb_run.log({"step": self.state.step,
                                        "train/step_loss": metrics["loss"].item(),
                                        "train/step_acc": metrics["accuracy"].item(), "lr": lr})
        if prof is not None:
            self._stop_profile(prof)
        sums = dict(zip(keys, totals.tolist())) if keys else {}  # the epoch's one read
        elapsed = time.perf_counter() - t0
        avg = {k: v / max(count, 1) for k, v in sums.items()}
        avg["images_per_sec"] = images_seen / max(elapsed, 1e-9)
        return avg

    def validate(self) -> Dict[str, float]:
        """The mean over the val batches of each batch's loss and accuracy; on
        a mesh each batch's are the global (padded) batch's, weighted as the
        JAX trainer weights its sharded eval batches."""
        totals, count = None, 0
        for images, labels in self._device_batches(self.val_loader):
            metrics = self._eval_step(images, labels)
            step_values = torch.stack([metrics["loss"], metrics["accuracy"]])
            totals = step_values if totals is None else totals + step_values
            count += 1
        loss, acc = totals.tolist() if totals is not None else (0.0, 0.0)
        return {"loss": loss / max(count, 1), "accuracy": acc / max(count, 1)}

    def train(self) -> Dict[str, Any]:
        tcfg = self.config.get("training", {})
        epochs = int(tcfg.get("epochs", 100))
        val_freq = int(tcfg.get("val_frequency", 1))
        save_freq = int(tcfg.get("save_frequency", 10))

        for epoch in range(self.start_epoch, epochs):
            train_metrics = self.train_epoch(epoch)
            epoch_lr = self.lr_schedule(self.state.step // self._lr_accum)
            self.history["train_loss"].append(train_metrics["loss"])
            self.history["train_acc"].append(train_metrics["accuracy"])
            self.history["lr"].append(epoch_lr)
            # the per-term curves (loss_main_ce, loss_triplet, loss_align, ...)
            for k, v in train_metrics.items():
                if k.startswith("loss_"):
                    self.history.setdefault(f"train_{k}", []).append(v)
            self.logger.info("epoch %d done: loss=%.4f acc=%.4f lr=%.2e (%.1f img/s)", epoch,
                             train_metrics["loss"], train_metrics["accuracy"], epoch_lr,
                             train_metrics["images_per_sec"])

            val_metrics = None
            if (epoch + 1) % val_freq == 0:
                val_metrics = self.validate()
                self.history["val_loss"].append(val_metrics["loss"])
                self.history["val_acc"].append(val_metrics["accuracy"])
                self.logger.info("epoch %d val: loss=%.4f acc=%.4f", epoch, val_metrics["loss"],
                                 val_metrics["accuracy"])
                if val_metrics["accuracy"] > self.best_val_acc:
                    self.best_val_acc = val_metrics["accuracy"]
                    save_checkpoint(str(self.ckpt_dir), self.state, epoch, self.best_val_acc,
                                    self.config, best=True)
            if self.wandb_run is not None:
                payload = {"epoch": epoch, "lr": epoch_lr,
                           **{f"train/{k}": v for k, v in train_metrics.items()}}
                if val_metrics is not None:
                    payload.update({f"val/{k}": v for k, v in val_metrics.items()})
                    payload["val/best_acc"] = self.best_val_acc
                self.wandb_run.log(payload)
            if (epoch + 1) % save_freq == 0:
                save_checkpoint(str(self.ckpt_dir), self.state, epoch, self.best_val_acc,
                                self.config)

        if self.rank == 0:
            try:
                from ..utils.viz import plot_training_curves

                plot_training_curves(self.history, str(self.output_dir / "training_curves.png"))
            except ImportError as exc:  # matplotlib is optional
                self.logger.warning("could not plot curves: %s", exc)

        return {"best_val_acc": self.best_val_acc, "history": self.history}
