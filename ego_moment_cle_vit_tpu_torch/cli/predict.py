"""Inference CLI, the single-view serving path (``make_infer_fn``):

    python -m ego_moment_cle_vit_tpu_torch.cli.predict --config configs/ufg_base.yaml \\
        --checkpoint DIR --images img1.jpg img2.jpg [--topk 5]
    python -m ego_moment_cle_vit_tpu_torch.cli.predict --config ... --checkpoint DIR \\
        --dataset-split test --limit 32

Without ``--checkpoint`` the model has random weights (smoke mode).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="EGO-Moment-CLE-ViT inference")
    parser.add_argument("--config", default="configs/ufg_base.yaml")
    parser.add_argument("--checkpoint", required=False, default=None)
    parser.add_argument("--images", nargs="*", default=None, help="image files")
    parser.add_argument("--dataset-split", default=None, help="classify a split")
    parser.add_argument("--limit", type=int, default=16)
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs (default: the GPU)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ego_moment_cle_vit_tpu_torch import create_model, make_infer_fn
    from ego_moment_cle_vit_tpu_torch.train.state import restore_checkpoint
    from ego_moment_cle_vit_tpu_torch.train.trainer import _augment_config, _make_dataset
    from ego_moment_cle_vit_tpu_torch.utils import load_config

    config = load_config(args.config)
    aug_cfg = _augment_config(config)

    num_classes = None
    class_names = None
    bundle = None
    if args.checkpoint:
        bundle = restore_checkpoint(args.checkpoint, device=args.device, optimizer=False)
        ckpt_cfg = bundle.get("config") or {}
        for key, val in ckpt_cfg.get("model", {}).items():
            config.setdefault("model", {}).setdefault(key, val)
        num_classes = ckpt_cfg.get("model", {}).get("num_classes")
    if num_classes is None:
        class_names = _make_dataset(config, "train").classes
        num_classes = len(class_names)

    model = create_model(config, num_classes, device=args.device)
    if bundle is not None:
        model.load_state_dict(bundle["model"])
    else:
        print("note: no --checkpoint given; using random weights (smoke mode)")
    infer = make_infer_fn(model, aug_cfg, device=args.device)

    names = []
    if args.images:
        from PIL import Image

        arrs = []
        for path in args.images:
            img = Image.open(path).convert("RGB").resize((aug_cfg.resize_size,
                                                          aug_cfg.resize_size))
            arrs.append(np.asarray(img, np.uint8))
            names.append(path)
        batch = np.stack(arrs)
    elif args.dataset_split:
        ds = _make_dataset(config, args.dataset_split)
        class_names = ds.classes
        samples = [ds[i] for i in range(min(args.limit, len(ds)))]
        names = [f"{args.dataset_split}[{i}] (true={lbl})" for i, (_, lbl) in enumerate(samples)]
        batch = np.stack([img for img, _ in samples])
    else:
        print("error: pass --images or --dataset-split")
        return 1

    probs = torch.softmax(infer(torch.from_numpy(batch)).float(), dim=-1).cpu().numpy()
    topk = np.argsort(-probs, axis=-1)[:, :args.topk]
    for name, idxs, p in zip(names, topk, probs):
        labels = [class_names[i] if class_names else str(i) for i in idxs]
        print(f"{name}: " + ", ".join(f"{lab} ({p[i]:.3f})" for lab, i in zip(labels, idxs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
