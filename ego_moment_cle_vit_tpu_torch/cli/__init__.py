"""Command-line entry points, run as modules:

    python -m ego_moment_cle_vit_tpu_torch.cli.train --config configs/ufg_base.yaml
    python -m ego_moment_cle_vit_tpu_torch.cli.eval --config ... --checkpoint DIR
    python -m ego_moment_cle_vit_tpu_torch.cli.predict --config ... --checkpoint DIR --images ...

They take the root ``train.py``, ``eval.py`` and ``predict.py``'s flags, with
``--device cuda|cpu`` (default ``cuda``).
"""
