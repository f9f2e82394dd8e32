"""Training CLI:
``python -m ego_moment_cle_vit_tpu_torch.cli.train --config configs/ufg_base.yaml
[--resume CKPT] [--batch_size N] [--lr F] [--epochs N] [--dataset NAME]
[--backbone NAME] [--seed N] [--device cuda|cpu] [--profile N]``.

On a mesh, one process per rank under ``torchrun``, with the config's
``experiment.mesh`` matching the world (``data: null`` takes every rank)::

    torchrun --nproc-per-node N -m ego_moment_cle_vit_tpu_torch.cli.train \
        --config CONFIG [--device cuda|cpu]

``--device cuda`` gives rank r the GPU ``cuda:{LOCAL_RANK}`` over NCCL;
``--device cpu`` runs the ranks on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Train EGO-Moment-CLE-ViT (PyTorch/CUDA)")
    parser.add_argument("--config", default="configs/ufg_base.yaml")
    parser.add_argument("--resume", default=None, help="checkpoint path to resume")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--backbone", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs (default: the GPU)")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="capture a torch.profiler trace of the first N steps "
                        "(log_dir/profile: trace.json and key_averages.txt, with the "
                        "emct.train.* phase spans, the emct.<layer> and "
                        "emct.kernel.<wrapper> spans and emct.data.wait)")
    args = parser.parse_args(argv)

    from ego_moment_cle_vit_tpu_torch.train import Trainer
    from ego_moment_cle_vit_tpu_torch.utils import load_config, merge_overrides

    config = merge_overrides(load_config(args.config), batch_size=args.batch_size, lr=args.lr,
                             epochs=args.epochs, dataset=args.dataset, backbone=args.backbone,
                             seed=args.seed)
    if args.profile:
        config.setdefault("experiment", {})["profile_steps"] = args.profile

    import torch.distributed as dist

    try:
        trainer = Trainer(config, device=args.device)
        trainer.setup_data()
        trainer.setup_model()
        if args.resume:
            trainer.resume(args.resume)
        results = trainer.train()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if trainer.rank == 0:
        print(f"best val accuracy: {results['best_val_acc']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
