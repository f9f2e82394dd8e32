"""Evaluation CLI:
``python -m ego_moment_cle_vit_tpu_torch.cli.eval --config configs/ufg_base.yaml
--checkpoint DIR [--no-viz] [--no-ablation] [--dataset NAME] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate EGO-Moment-CLE-ViT (PyTorch/CUDA)")
    parser.add_argument("--config", default="configs/ufg_base.yaml")
    parser.add_argument("--checkpoint", default=None, help="checkpoint dir/path")
    parser.add_argument("--no-viz", action="store_true")
    parser.add_argument("--no-ablation", action="store_true")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs (default: the GPU)")
    args = parser.parse_args(argv)

    from ego_moment_cle_vit_tpu_torch.train import Evaluator
    from ego_moment_cle_vit_tpu_torch.utils import load_config, merge_overrides

    config = merge_overrides(load_config(args.config), dataset=args.dataset)
    evaluator = Evaluator(config, args.checkpoint, device=args.device)
    evaluator.evaluate(visualize=not args.no_viz, ablation=not args.no_ablation)
    return 0


if __name__ == "__main__":
    sys.exit(main())
