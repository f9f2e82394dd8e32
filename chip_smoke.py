#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py                 # what the check runs: one card
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table

Phases (any failed check exits non-zero; no phase catches and continues):

1. Setup: card name and power limit, kernel build from ``csrc/`` (seconds),
   and ptxas's register, spill and wgmma notes (a C7511 note says a wgmma was
   serialized).

2. Every kernel wrapper at its main paths' calls (``kernel_checks.MAIN_PATH``:
   batch 64 serving, 128 views training, each configuration's shapes, bf16)
   through its check in ``kernel_checks.py``, the one
   ``tests/test_torch_cuda.py`` runs at every case: against its plain version
   on the same inputs within its tolerance, a control that must fail, one
   launch a call, and the same bits twice where the check holds them.  Each
   call and its plain version are then timed on those inputs (CUDA events).
   The SASS of each library, and the edges of the tiles, are the card tests'
   alone; ``kernel_turns.py`` times the kernels against another checkout.

The phases below drive the paths that launch them:

3. Serving end to end: the flagship configuration (Swin-Base/224 bf16, GPF
   2x2 dot, moment d_out 1024 with the FFT sketch, bf16 vech projection,
   'add' classifier, 80 classes) with seeded random weights, uint8
   [64, 256, 256, 3] through ``make_infer_fn``.  Checks finite [64, 80]
   logits, 24 window-attention launches and 1 GPF launch per forward, and the
   logits against the same model with every kernel swapped for its plain
   version (bf16 at batch 64, fp32 at batch 8), and rejects the kernel run
   with its bias omitted.  Relative-position tables are drawn at std 1, as
   trained ones reach, so the bias matters.  Prints images/s and peak memory.
4. Training end to end: the same configuration with the flagship's training
   section (lambda_triplet 0.6, lambda_align 0.1, margin 0.3, lr 3e-4, dropout
   0.1, factored second moment for the 269M-element leaf) through
   ``create_train_state`` and ``make_train_step``, uint8 [64, 256, 256, 3] and
   labels in [0, 80), on fixed data.  Checks per step 24 + 24 window-attention
   and 1 + 1 GPF launches, a finite loss every step that ends below where it
   began, no skipped step, and one step's parameter gradients against the
   same step with every kernel swapped for its plain version (bf16 at batch
   64, fp32 at batch 4; dropout off, same views), which must also reject the
   kernel run with its bias gradient dropped.  Prints images/s, step ms and
   peak memory.
5. Phases 3 and 4 again on the other model family, ViT-Base/224 with the same
   heads: 12 packed-attention launches and 1 GPF launch per forward, 12 + 12
   and 1 + 1 per train step.  A ViT has no bias table, so its controls are
   the kernel run with only the first 64 keys attended (serving) and with dK
   dropped (training).
5c, 5d. Phases 3 and 4 once more on ViT-Base at a 448 input (uint8
   [64, 600, 600, 3], 785 tokens, N = 784 >= D = 768): 12 q-tiled attention
   launches, 1 GPF launch and 1 Newton-Schulz launch per forward (no packed
   attention), 12 + 12, 1 + 1 and 1 per train step.  The plain path holds
   [B, 12, 785, 785] fp32 probabilities, so the comparisons with it run at
   batch 8 in bf16 and 2 in fp32 (serving and training alike).  Controls: the
   first 64 keys only (computed in plain PyTorch: the tiled kernel takes no
   mask), dK dropped.  The fp32 gradient of the GPF coefficients, an
   ill-conditioned sum at N = 784, is also held against the plain path run
   in fp64 on three view seeds, where two planted faults in its dc (the last
   token tile skipped, a bf16 cotangent) must fail.
3f, 4f. Phases 3 and 4 on Swin-Base/224 under backbone_attn_kernel
   'fused_half': 4 fused attention-half launches (stages 0-1), 20 window
   attention and 1 GPF per forward; 4 + 4, 20 + 20 and 1 + 1 per train step.
   Controls: the fused kernel without its bias (serving), its dwqkv dropped
   (training).  The logits are also held against the default path on the same
   weights: 2e-2 relative L2 in bf16 (batch 64), 1e-3 of max |logit| in fp32
   (batch 8).  The training phase also times, without a profiler, the host's
   time from each step call to its return on both paths in turns (20 steps
   each).
5e, 5f, 5g. The dense route's bf16 Newton-Schulz variants on their paths:
   ViT-Large/16 at 512 (uint8 [64, 600, 600, 3], 1025 tokens of 1024, N = D
   = 1024) served and trained under block checkpointing, and Swin-Large at
   1280 (uint8 [64, 1463, 1463, 3]; stage canvases 320, 160, 80, 40 padded to
   322, 161, 84, 42; N = 1600 >= D = 1536) served.  Launches: ViT-Large 24
   q-tiled, 1 GPF and 1 kernel-5′ per forward, 48 + 24 q-tiled (the forward
   again under checkpointing), 1 + 1 GPF and 1 kernel-5′ per step;
   Swin-Large 24 window attention, 1 GPF and 1 kernel-5″ per forward.  The
   comparisons with the plain path run at batch 8 in bf16 and 2 in fp32; the
   plain path rounds the iteration where the kernel does.  Controls: the first
   64 keys only and dK dropped (ViT-Large); the bias omitted and the pad
   sentinel removed from the masks (Swin-Large).
   Phases 3, 5, 6 and 7 count kernel 7's launch (the moment head's
   token-subspace iSQRT without a gradient) on every serving path whose head
   takes the subspace route (N < D), and their plain paths run
   ``isqrt_cov_subspace`` in its place.
5h. Phase 3 on EVA-02-Large/14 at 448 (uint8 [64, 600, 600, 3], 1025 tokens,
   N = D = 1024): 24 q-tiled attention, 24 SwiGLU-glue, 1 GPF and 1 kernel-5′
   launches per forward; the plain path (the composition in the glue's place)
   at batch 8 in bf16 and 2 in fp32 (where the glue takes the composition on
   both sides).  Its bf16 logits move more between the two paths than the
   other families' (24 blocks at 1025 tokens carry the few elements whose
   rounding differs), so they are held by relative L2 (TOL_EVA_LOGITS_REL).
   Control: the glue with gate and value swapped.
6. The data pipeline, trainer, evaluator and checkpoints on Swin-Base/224
   (the flagship configuration, batch 64) over the synthetic dataset, 80
   classes x 8 images a split at resize 256 (640 images, 10 steps an epoch):
   (a) ``Trainer`` from the device cache for 2 epochs with validation and a
   checkpoint every epoch: every step's loss finite and launches 24 + 24
   window attention and 1 + 1 GPF, ``checkpoint_epoch_0``, ``_1`` and
   ``best_model`` with their ``.meta.json`` written; (b) a second trainer
   resumed from ``checkpoint_epoch_0`` runs epoch 1 to the first one's
   parameters bit for bit (control: the optimizer's moments zeroed); (c) one
   epoch from the host loader (``HostDecodedCache`` -> ``BatchLoader`` ->
   ``DevicePrefetcher``): every batch the step receives equals the device
   cache's, hashed on the device, and the epoch's loss equals the device
   cache's epoch 0 bit for bit (control: a prefetcher that reuses one pinned
   buffer without waiting); (d) the same step through ``make_train_step`` on
   a fixed batch; (e) ``Evaluator`` on ``best_model`` with the ablations and
   TTA (0.9, 1.0): the first batch's logits against the plain path and
   against ``make_infer_fn`` (control: the bias omitted).  Prints
   ``train_epoch``'s images/s from the device cache and from the host loader
   beside the fixed-batch step's, and the evaluator's beside
   ``make_infer_fn``'s.
7. The remaining model and training options, at batch 64.  (a) The
   flagship with adaptive GPF 'attention' (per-sample coefficients, plain
   PyTorch: no GPF kernel), BatchNorm head norms, the adaptive classifier and
   ``accumulation_steps: 2``: one update's parameter gradients (BatchNorms on
   the batch's statistics, dropout off) against the plain path, bf16 at 64
   and fp32 at 4 (control: bias gradient dropped); 8 micro-steps through
   ``make_train_step``, each with 24 + 24 window-attention launches and a
   finite loss, parameters bit for bit unmoved after the odd micro-steps and
   moved after the even ones (control: an update every micro-step), the
   running statistics moved on every one (control: an eval forward), no
   skipped update; then serving on the running statistics, logits against
   the plain path (control: train-mode BatchNorm).  (b) ViT-L/16 at 448 with
   the multi-scale classifier (BASELINE.json configs[4]; 785 tokens, N = 784
   < D = 1024, the subspace head; block checkpointing): phases 3 and 4's
   checks, 24 q-tiled and 1 GPF launches a forward, 48 + 24 and 1 + 1 a
   step, 10 steps.  (c) Adaptive 'global' (1 + 1 GPF launches), 'spatial'
   (none), the simplified head, the bilinear fusion and ``norm: none`` on
   the flagship: a forward and two steps each, finite logits, loss and
   gradients, logits against the plain path at batch 8 (control, once:
   bias omitted).  Each prints images/s, step ms and peak memory.
8. Data x model parallelism on the flagship, global batch 64 (``mesh_phase``):
   a 1 x 1 mesh under NCCL in this process against ``make_train_step``, then
   meshes of 2 and 4 ranks sharing the card under gloo (gradients against one
   process, launches per rank, replicated leaves after three steps) and a
   ``Trainer`` epoch on (2, 1) restored on the 1 x 1 mesh.

The last two lines are a JSON line of every kernel, with phase 2's ms,
plain_ms and launches a call at each of its calls and its launches on every
path of phases 3-8 that ran it (a kernel that none launched fails the run),
and the contract's, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

import kernel_checks
from ego_moment_cle_vit_tpu_torch import (
    create_model,
    create_train_state,
    make_infer_fn,
    make_train_step,
)
from ego_moment_cle_vit_tpu_torch.data import (
    AugmentConfig,
    BatchLoader,
    DeviceDatasetCache,
    HostDecodedCache,
    dual_view_train_batch,
)
from ego_moment_cle_vit_tpu_torch.data import pipeline as _pipeline
from ego_moment_cle_vit_tpu_torch.kernels import _build
from ego_moment_cle_vit_tpu_torch.kernels import attn_half as _ah
from ego_moment_cle_vit_tpu_torch.kernels import flash_attention as _fa
from ego_moment_cle_vit_tpu_torch.kernels import gpf as _gpf
from ego_moment_cle_vit_tpu_torch.kernels import newton_schulz as _ns
from ego_moment_cle_vit_tpu_torch.kernels import packed_attention as _pa
from ego_moment_cle_vit_tpu_torch.kernels import subspace_isqrt as _si
from ego_moment_cle_vit_tpu_torch.kernels import swiglu_norm as _sn
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as _wa
from ego_moment_cle_vit_tpu_torch.models import ego_moment_clevit as _model_module
from ego_moment_cle_vit_tpu_torch.models import layers as _layers
from ego_moment_cle_vit_tpu_torch.models.eva import SwiGLU
from ego_moment_cle_vit_tpu_torch.models.layers import BatchNorm
from ego_moment_cle_vit_tpu_torch.models.swin import SwinBlock, _attn_mask
from ego_moment_cle_vit_tpu_torch.ops.moments import isqrt_cov_subspace
from ego_moment_cle_vit_tpu_torch.parallel import (
    create_mesh,
    gather_params,
    kernel_mesh,
    load_params,
    shard_params,
    sharded_params,
)
from ego_moment_cle_vit_tpu_torch.parallel.collectives import sum_gradients_over_data
from ego_moment_cle_vit_tpu_torch.parallel.sharding import unshard
from ego_moment_cle_vit_tpu_torch.train import Evaluator, Trainer, restore_checkpoint
from ego_moment_cle_vit_tpu_torch.train import trainer as _trainer_module
from ego_moment_cle_vit_tpu_torch.utils.device import pin_fp32_precision

BATCH = 64
TRAIN_VIEWS = 2 * BATCH  # the dual-view step runs both views as one backbone batch
FLAGSHIP = {
    "model": {
        "backbone_name": "swin_base_patch4_window7_224",
        "norm": "layer",
        "bf16": True,
        "gpf": {"degree_p": 2, "degree_q": 2, "similarity": "dot"},
        "moment": {"d_out": 1024, "use_third_order": True, "isqrt_iterations": 5,
                   "sketch_dim": 4096, "bf16_params": True},
        "classifier": {"fusion_type": "add"},
    },
    "data": {"input_size": 224, "resize_size": 256},
    "training": {
        "batch_size": BATCH,
        "optimizer": {"lr": 3e-4, "factored_large_leaves": True},
        "scheduler": {"warmup_epochs": 0},
        "loss": {"lambda_triplet": 0.6, "lambda_align": 0.1, "margin": 0.3},
        "epochs": 1,
    },
}
VIT_FLAGSHIP = json.loads(json.dumps(FLAGSHIP))
VIT_FLAGSHIP["model"]["backbone_name"] = "vit_base_patch16_224"
VIT_T, VIT_C, VIT_H, VIT_DEPTH = 197, 768, 12, 12  # ViT-Base/224: tokens, width, heads, blocks
VIT448_FLAGSHIP = json.loads(json.dumps(VIT_FLAGSHIP))
VIT448_FLAGSHIP["data"] = {"input_size": 448, "resize_size": 600}  # AugmentConfig's defaults
NS_ITERS, NS_EPS = 5, 1e-5  # the flagship head's isqrt_iterations and eps
# ViT-Large/16 at a 512 input: 1025 tokens of 1024, 16 heads of 64, 24 blocks;
# N = D = 1024 takes the dense route through kernel 5′.  Trained under block
# checkpointing: without it its activations (~3.5x ViT-Base/448's 39.4 GiB)
# would not fit the card.
VITL_T, VITL_C, VITL_H, VITL_DEPTH = 1025, 1024, 16, 24
VITL512_FLAGSHIP = json.loads(json.dumps(VIT448_FLAGSHIP))
VITL512_FLAGSHIP["model"]["backbone_name"] = "vit_large_patch16_224"
VITL512_FLAGSHIP["model"]["backbone_remat"] = "block"
VITL512_FLAGSHIP["data"] = {"input_size": 512, "resize_size": 600}
# EVA-02-Large/14 at 448: 1025 tokens of 1024, 16 heads of 64, 24 blocks with
# the SwiGLU (hidden 2730, padded to 2736 on the card); N = D = 1024: the
# dense route through kernel 5′
EVA448_FLAGSHIP = json.loads(json.dumps(VIT448_FLAGSHIP))
EVA448_FLAGSHIP["model"]["backbone_name"] = "eva02_large_patch14_448"
# Swin-Large at a 1280 input (the flagship's 256 / 224 resize ratio): stage
# canvases 320, 160, 80, 40 padded to 322, 161, 84, 42 for windows of 7, heads
# of 32; the last stage's 1600 tokens >= D = 1536 take the dense route through
# kernel 5″
SWINL1280_FLAGSHIP = json.loads(json.dumps(FLAGSHIP))
SWINL1280_FLAGSHIP["model"]["backbone_name"] = "swin_large_patch4_window7_224"
SWINL1280_FLAGSHIP["data"] = {"input_size": 1280, "resize_size": 1463}
SWINL_N, SWINL_C = 1600, 1536
TRAIN_STEPS_PER_EPOCH = 100
# phase 7a: the flagship with the options users' configurations select
# together: per-sample adaptive GPF (BASELINE.json configs[3]), BatchNorm
# head norms (configs/ufg_base.yaml's reference-parity setting), the
# squeeze-and-excitation classifier, two micro-steps an update
OPTIONS_BN_FLAGSHIP = json.loads(json.dumps(FLAGSHIP))
OPTIONS_BN_FLAGSHIP["model"]["norm"] = "batch"
OPTIONS_BN_FLAGSHIP["model"]["gpf"]["adaptive_type"] = "attention"
OPTIONS_BN_FLAGSHIP["model"]["classifier"]["type"] = "adaptive"
OPTIONS_BN_FLAGSHIP["training"]["accumulation_steps"] = 2
OPTIONS_MICRO_STEPS = 8
# phase 7b: ViT-L/16 at 448 with the multi-scale classifier (BASELINE.json
# configs[4]); 785 tokens, N = 784 < D = 1024: the token-subspace head; block
# checkpointing as ViT-Large/512 trains
VITL448_MS_FLAGSHIP = json.loads(json.dumps(VITL512_FLAGSHIP))
VITL448_MS_FLAGSHIP["data"] = {"input_size": 448, "resize_size": 600}
VITL448_MS_FLAGSHIP["model"]["classifier"]["type"] = "multiscale"
# phase 7c: the other options, one at a time on the flagship
OTHER_OPTIONS = (
    ("adaptive_type: global", {"gpf": {"adaptive_type": "global"}}),
    ("adaptive_type: spatial", {"gpf": {"adaptive_type": "spatial"}}),
    ("moment.variant: simplified", {"moment": {"variant": "simplified"}}),
    ("classifier.fusion_type: bilinear", {"classifier": {"fusion_type": "bilinear"}}),
    ("norm: none", {"norm": "none"}),
)
# serving logits, of max |plain logit|: fp32 by sum order; bf16 set between
# the error of sound runs (9.8e-3, 1.06e-2 on an H100) and that of the
# bias-omitted control (1.12e-1), ~3x from each
TOL_LOGITS_REL = {torch.bfloat16: 3e-2, torch.float32: 1e-3}
# phase 6's evaluator in fp32 on the trained checkpoint, of max |plain logit|:
# sound runs differ by sum order (2.8e-7 on an H100; phases 3-5g read up to
# 1.7e-6), the bias-omitted control by 1.16e-3, too close to 1e-3 for
# TOL_LOGITS_REL: ~60x over the first, ~12x under the second
TOL_EVAL_LOGITS_REL_FP32 = 1e-4
BIAS_TABLE_STD = 1.0  # trained Swin tables reach this; at init (0.02) the bias is invisible
# one step's parameter gradients, kernel path vs plain path, per leaf:
# ||g - g_ref|| / ||g_ref||.  fp32 differs by sum order; bf16 by the forward
# kernel rounding P where the plain version does not, carried through 24
# blocks (sound runs on an H100: <= 4e-2 in bf16, <= 4e-6 in fp32; the control
# with the bias gradient dropped: 1.0).
TOL_GRADS_REL = {torch.bfloat16: 0.1, torch.float32: 2e-3}
# The GPF coefficients are held apart in bf16.  The moment head normalizes the
# fused graph, so the loss barely changes when the graph is scaled, and each
# dc[p, q] = sum(df * A_p * B_q) is a cancellation of terms up to ~1e12 (dot
# Grams of 1024-wide tokens) down to ~1e-7: bf16 noise in df decides it
# (measured 0.7-0.9 relative in bf16, 3e-4 in fp32).  Its kernel is held
# tightly on shared inputs by tests/test_torch_cuda.py; here it must be finite
# and of the reference's order of magnitude.
TOL_GRADS_REL_ILL_CONDITIONED = {"gpf.alpha_coeffs": {torch.bfloat16: 3.0}}
# The fused path rounds the attention half's residual once from fp32 where
# the default path adds in bf16, so its bf16 tokens carry other noise, and
# this leaf, decided by that noise, read 3.04 relative (chip run, H100); it
# is held to its order of magnitude.  Every other leaf keeps TOL_GRADS_REL.
TOL_GRADS_REL_ILL_CONDITIONED_FUSED = {"gpf.alpha_coeffs": {torch.bfloat16: 10.0}}
# At a 448 input the GPF Grams are 784 x 784, so each dc[p, q] cancels 16x the
# terms it does at 196 tokens, and fp32 rounding alone decides its third digit
# (kernel path vs plain path 1.5e-3 relative, against 6.1e-5 at 224; every
# other leaf is held to TOL_GRADS_REL).  The fp32 limit is set between what
# coefficient_gradient_witness read against the fp64 path on an H100 (3 view
# seeds): kernel path 4.6e-4 to 2.2e-3, plain path 3.6e-4 to 8.1e-4; dc from a
# bf16 cotangent 4.7e-2 to 0.23; the last token tile skipped 244 to 1341.
TOL_GRADS_REL_ILL_CONDITIONED_448 = {
    "gpf.alpha_coeffs": {torch.bfloat16: 3.0, torch.float32: 1e-2}}
# ViT-Large at 512: each dc[p, q] cancels the Gram terms of 1024 tokens, and
# in bf16 the leaf read 3.25 relative kernel path vs plain path (measured on an
# H100; every other leaf <= 2.1e-2): like the fused path's, it is held to its order
# of magnitude in bf16.  In fp32 it keeps the 448 bar.
TOL_GRADS_REL_ILL_CONDITIONED_VITL = {
    "gpf.alpha_coeffs": {torch.bfloat16: 10.0, torch.float32: 1e-2}}
# Phase 7a's per-sample GPF coefficients come from coeff_mod, whose gradient
# carries each sample's dc[p, q], the same cancellation as gpf.alpha_coeffs':
# both held at that leaf's bf16 bar.  Behind the BatchNorms the cancellation
# reads ~60x its LayerNorm size in fp32 too (3.9e-3 for alpha_coeffs and
# coeff_mod.bias on an H100, 6.1e-5 at phase 4): the 448 path's fp32 bar.
TOL_GRADS_REL_ILL_CONDITIONED_ADAPTIVE = {
    name: {torch.bfloat16: 3.0, torch.float32: 1e-2}
    for name in ("gpf.alpha_coeffs", "gpf.coeff_mod.weight", "gpf.coeff_mod.bias")}
# Biases that shift every sample alike ahead of a BatchNorm on the batch's
# statistics have zero gradient in exact arithmetic, so their relative error
# is noise over noise.  In fp32 each is held to be small against its layer's
# weight gradient instead (the norm's backward sums in fp32: ~1e-6 of it
# expected); in bf16 the Dense's output gradient is rounded to bf16 before
# its batch sum, which leaves noise at the terms' own size (read 0.97 of the
# weight gradient's norm on an H100), so there only finiteness is held.
TOL_ZERO_GRAD = {torch.float32: 1e-3, torch.bfloat16: math.inf}
# Phase 7a's BatchNorms divide their input's rounding noise by its batch std,
# small beside the whitened vech features' size (~60x on the CPU test's
# heads), so the bf16 noise behind every head leaf grows: a sound run on an
# H100 read up to 0.114 (classifier.se_fc1.bias), 0.099 (second_norm's
# bias), 0.06 (second_proj, the deepest bias tables), against 4e-2 at most
# with LayerNorm.  The bf16 bar sits between that and the control's 1.0,
# ~3x from each; fp32 keeps phase 4's.
TOL_GRADS_REL_BN = {torch.bfloat16: 0.3, torch.float32: TOL_GRADS_REL[torch.float32]}
ZERO_GRAD_LEAVES_BN = {f"{layer}.bias": f"{layer}.weight" for layer in (
    "moment_head.second_proj", "moment_head.third_proj", "classifier.fc1", "classifier.fc2")}
# The multi-scale head's attention adds its key bias to every key alike, and
# a softmax does not see a shift shared by its row: zero gradient in exact
# arithmetic (read 1.74 relative, kernel path vs plain path, in bf16)
ZERO_GRAD_LEAVES_MULTISCALE = {"classifier.scale_attention.key.bias":
                               "classifier.scale_attention.key.weight"}
COEFF_WITNESS_SEEDS = (2, 3, 4)  # view seeds of the 448 witness; 2 is the check's own
# EVA-02-L/448 served, bf16 logits of the kernel path against the plain path
# at batch 8, relative L2 (see 5h in the docstring): 0.052 on an H100 (max
# |err| 5.7e-2 of max |logit|, past TOL_LOGITS_REL), 1.24 with the glue's gate
# and value swapped; ~3x over the first, ~8x under the second
TOL_EVA_LOGITS_REL = 0.15
# the fused path against the default path on the same weights: bf16 logits
# within 2e-2 relative L2 (the JAX package's bar, tests/test_attn_half.py);
# fp32 logits within 1e-3 of max |logit|
TOL_FUSED_VS_DEFAULT = {torch.bfloat16: 2e-2, torch.float32: 1e-3}

# every kernel wrapper, by name: their ``launches`` counts, read before any
# control or plain path stands in for one
COUNTERS = _build.wrappers()


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20, samples: int = 5, warm: int = 3) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back calls,
    after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper the model calls for its plain version.  The
    Newton–Schulz dispatch then reaches the plain version of the variant its
    width picks, so the plain path rounds where the kernel path does; the
    subspace iSQRT's plain version is the fp32 route ``isqrt_cov_subspace``, the
    SwiGLU glue's the composition it replaces."""
    saved = (_wa.window_attention_fwd, _wa.window_attention_bwd, _gpf.gpf_fwd, _gpf.gpf_bwd,
             _pa.packed_attention_fwd, _pa.packed_attention_bwd, _fa.flash_attention_tiled_fwd,
             _fa.flash_attention_tiled_bwd, _ns.newton_schulz_isqrt_fp32_fwd,
             _ns.newton_schulz_isqrt_bf16_fwd, _ns.newton_schulz_isqrt_bf16_streamed_fwd,
             _ah.attn_half_fwd, _ah.attn_half_bwd, _si.subspace_isqrt_fwd, _sn.swiglu_norm_fwd)
    _wa.window_attention_fwd = _wa.window_attention_plain
    _wa.window_attention_bwd = _wa.window_attention_bwd_plain
    _gpf.gpf_fwd = _gpf.gpf_plain
    _gpf.gpf_bwd = _gpf.gpf_bwd_plain
    _pa.packed_attention_fwd = _pa.packed_attention_plain
    _pa.packed_attention_bwd = (
        lambda *args, need_dbias=True: _pa.packed_attention_bwd_plain(*args))
    _fa.flash_attention_tiled_fwd = _fa.flash_attention_tiled_plain
    _fa.flash_attention_tiled_bwd = (
        lambda qkv, out, lse, dout, num_heads: _fa.flash_attention_tiled_bwd_plain(
            qkv, dout, num_heads))
    _ns.newton_schulz_isqrt_fp32_fwd = _ns.newton_schulz_isqrt_plain
    _ns.newton_schulz_isqrt_bf16_fwd = _ns.newton_schulz_isqrt_bf16_plain
    _ns.newton_schulz_isqrt_bf16_streamed_fwd = _ns.newton_schulz_isqrt_bf16_streamed_plain
    _ah.attn_half_fwd = _ah.attn_half_plain
    _ah.attn_half_bwd = _ah.attn_half_bwd_plain
    _si.subspace_isqrt_fwd = isqrt_cov_subspace
    _sn.swiglu_norm_fwd = _sn.swiglu_norm_plain
    try:
        yield
    finally:
        (_wa.window_attention_fwd, _wa.window_attention_bwd, _gpf.gpf_fwd, _gpf.gpf_bwd,
         _pa.packed_attention_fwd, _pa.packed_attention_bwd, _fa.flash_attention_tiled_fwd,
         _fa.flash_attention_tiled_bwd, _ns.newton_schulz_isqrt_fp32_fwd,
         _ns.newton_schulz_isqrt_bf16_fwd, _ns.newton_schulz_isqrt_bf16_streamed_fwd,
         _ah.attn_half_fwd, _ah.attn_half_bwd, _si.subspace_isqrt_fwd, _sn.swiglu_norm_fwd) = saved


@contextlib.contextmanager
def only_first_keys_attended(model: torch.nn.Module):
    """Control for a model without bias tables: the packed kernel runs, but
    every query sees the first 64 keys only, as if the walk over the key tiles
    stopped after the first.  The serving check must see it."""
    del model
    saved = _pa.packed_attention_fwd

    def truncated(qkv, bias, mask, num_heads, scale=None, return_lse=False):
        t = qkv.shape[2]
        hide = torch.zeros(1, t, t, dtype=torch.float32, device=qkv.device)
        hide[:, :, _pa.TILE:] = -100.0
        return saved(qkv, bias, hide if mask is None else mask + hide, num_heads, scale,
                     return_lse)

    truncated.launches = 0  # the wrapper counts on whatever the module name holds
    _pa.packed_attention_fwd = truncated
    try:
        yield
    finally:
        _pa.packed_attention_fwd = saved


@contextlib.contextmanager
def key_gradient_dropped():
    """Control for a model without bias tables: the packed backward kernel
    runs but its dK is thrown away, a fault the training gradient check must
    see."""
    saved = _pa.packed_attention_bwd

    def dropped(*args, **kwargs):
        dqkv, dbias = saved(*args, **kwargs)
        c = dqkv.shape[-1] // 3
        dqkv[..., c:2 * c] = 0
        return dqkv, dbias

    dropped.launches = 0  # the wrapper counts on whatever the module name holds
    _pa.packed_attention_bwd = dropped
    try:
        yield
    finally:
        _pa.packed_attention_bwd = saved


def first_keys_attention(qkv: torch.Tensor, num_heads: int, keys: int = _fa.TILE):
    """Attention of every query over the first ``keys`` keys only, in plain
    PyTorch (fp32 inside, P rounded to qkv's dtype): (out [B, N, C], lse)."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    x = qkv.float().reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(x[0], x[1][:, :, :keys].transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype).float()
    out = torch.matmul(probs, x[2][:, :, :keys]).permute(0, 2, 1, 3).reshape(b, n, c3 // 3)
    return out.to(qkv.dtype), torch.logsumexp(logits, dim=-1)


@contextlib.contextmanager
def only_first_keys_attended_tiled(model: torch.nn.Module):
    """Control for the long-sequence path: every query sees the first 64 keys
    only, as if the q-tiled kernel's walk over the key tiles stopped after the
    first.  The tiled kernel takes no mask, so the control computes that
    attention in plain PyTorch.  The serving check must see it."""
    del model
    saved = _fa.flash_attention_tiled_fwd

    def truncated(qkv, num_heads):
        return first_keys_attention(qkv, num_heads)

    truncated.launches = 0  # the wrapper counts on whatever the module name holds
    _fa.flash_attention_tiled_fwd = truncated
    try:
        yield
    finally:
        _fa.flash_attention_tiled_fwd = saved


@contextlib.contextmanager
def key_gradient_dropped_tiled():
    """Control for the long-sequence path: the q-tiled backward kernel runs
    but its dK is thrown away, a fault the training gradient check must see."""
    saved = _fa.flash_attention_tiled_bwd

    def dropped(*args, **kwargs):
        dqkv = saved(*args, **kwargs)
        c = dqkv.shape[-1] // 3
        dqkv[..., c:2 * c] = 0
        return dqkv

    dropped.launches = 0  # the wrapper counts on whatever the module name holds
    _fa.flash_attention_tiled_bwd = dropped
    try:
        yield
    finally:
        _fa.flash_attention_tiled_bwd = saved


@contextlib.contextmanager
def coefficient_gradient_faulted(fault: str):
    """Planted faults in the GPF backward's coefficient gradient dc; its
    token gradients stay sound.  'tail': the reduction skips the last,
    partial tile of 64 tokens (rows and columns 768-783 at N = 784).  'bf16':
    dc summed from the cotangent rounded to bf16.  The 448 check of that
    leaf against the fp64 path must see both."""
    saved = _gpf.gpf_bwd

    def faulty(tokens_a, tokens_p, coeffs, g, *options):
        dta, dtp, _ = saved(tokens_a, tokens_p, coeffs, g, *options)
        if fault == "tail":
            g = g.clone()
            keep = g.shape[-1] // _gpf.TILE * _gpf.TILE
            g[:, keep:, :] = 0
            g[:, :, keep:] = 0
        else:
            g = g.to(torch.bfloat16).float()
        return dta, dtp, saved(tokens_a, tokens_p, coeffs, g, *options)[2]

    faulty.launches = 0  # the wrapper counts on whatever the module name holds
    _gpf.gpf_bwd = faulty
    try:
        yield
    finally:
        _gpf.gpf_bwd = saved


@contextlib.contextmanager
def bias_gradient_dropped():
    """Control: the backward kernel runs but its bias gradient is thrown
    away, a fault the training gradient check must see."""
    saved = _wa.window_attention_bwd

    def dropped(*args):
        dqkv, dbias = saved(*args)
        return dqkv, torch.zeros_like(dbias)

    dropped.launches = 0  # the wrapper counts on whatever the module name holds
    _wa.window_attention_bwd = dropped
    try:
        yield
    finally:
        _wa.window_attention_bwd = saved


@contextlib.contextmanager
def fused_bias_omitted(model: torch.nn.Module):
    """Control for the fused path: the attention-half kernel runs with its
    relative-position bias at zero (the other blocks keep theirs), a fault the
    serving check must see."""
    del model
    saved = _ah.attn_half_fwd

    def omitted(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, *rest):
        return saved(x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, torch.zeros_like(bias), *rest)

    omitted.launches = 0  # the wrapper counts on whatever the module name holds
    _ah.attn_half_fwd = omitted
    try:
        yield
    finally:
        _ah.attn_half_fwd = saved


@contextlib.contextmanager
def qkv_weight_gradient_dropped():
    """Control for the fused path: the attention-half backward kernel runs but
    its dwqkv is thrown away, a fault the training gradient check must see."""
    saved = _ah.attn_half_bwd

    def dropped(*args):
        grads = saved(*args)
        return (*grads[:3], torch.zeros_like(grads[3]), *grads[4:])

    dropped.launches = 0  # the wrapper counts on whatever the module name holds
    _ah.attn_half_bwd = dropped
    try:
        yield
    finally:
        _ah.attn_half_bwd = saved


@contextlib.contextmanager
def swiglu_gate_and_value_swapped(model: torch.nn.Module):
    """Every SwiGLU's fc1_g and fc1_x swapped: the glue's kernel computes
    silu(u) g."""
    mlps = [m for m in model.modules() if isinstance(m, SwiGLU)]
    for m in mlps:
        m.fc1_g, m.fc1_x = m.fc1_x, m.fc1_g
    try:
        yield
    finally:
        for m in mlps:
            m.fc1_g, m.fc1_x = m.fc1_x, m.fc1_g


def reset_launches() -> None:
    for kernel in COUNTERS.values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: kernel.launches for name, kernel in COUNTERS.items()}


def bias_tables(model: torch.nn.Module) -> list:
    return [p for name, p in model.named_parameters()
            if name.endswith("relative_position_bias_table")]


@contextlib.contextmanager
def bias_omitted(model: torch.nn.Module):
    """Control: the kernels run with every relative-position bias at zero, a
    fault the serving check must see."""
    saved = [p.detach().clone() for p in bias_tables(model)]
    with torch.no_grad():
        for p in bias_tables(model):
            p.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(bias_tables(model), saved):
                p.copy_(v)


@contextlib.contextmanager
def pad_sentinel_removed(model: torch.nn.Module):
    """Control for padded canvases: every block whose canvas is padded runs
    with the mask its shift alone gives, without the pad sentinel, so real
    queries attend the pad tokens' keys.  The serving check must see it."""
    saved = []
    for blk in model.modules():
        if isinstance(blk, SwinBlock) and (blk.hp, blk.wp) != blk.res:
            mask = _attn_mask(blk.hp, blk.wp, blk.hp, blk.wp, blk.ws, blk.shift)
            saved.append((blk, blk.attn_mask))
            blk.attn_mask = (None if mask is None
                             else torch.as_tensor(mask, device=blk.attn_mask.device))
    if not saved:
        fail("the pad control found no padded canvas")
    try:
        yield
    finally:
        for blk, mask in saved:
            blk.attn_mask = mask


def redraw_bias_tables(model: torch.nn.Module, g: torch.Generator) -> None:
    """Relative-position tables at BIAS_TABLE_STD, so that a kernel which
    mishandles the bias moves the logits."""
    with torch.no_grad():
        for p in bias_tables(model):
            p.normal_(0.0, BIAS_TABLE_STD, generator=g)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# phase 2: every kernel at its main paths' calls


def main_path_kernels() -> dict:
    """Each wrapper's check at its ``kernel_checks.MAIN_PATH`` calls, then
    the call and its plain version timed on the check's inputs: {wrapper:
    [{"call", "ms", "plain_ms", "launches_a_call"}, ...]}."""
    if set(kernel_checks.MAIN_PATH) != set(COUNTERS):
        fail(f"kernel_checks.MAIN_PATH names {sorted(kernel_checks.MAIN_PATH)}, the port's "
             f"wrappers are {sorted(COUNTERS)}")
    dev = torch.device("cuda")
    res = {}
    for name, (check, cases) in kernel_checks.MAIN_PATH.items():
        res[name] = []
        for case in cases:
            call = f"{check.__name__}{tuple(str(a).replace('torch.', '') for a in case)}"
            try:
                kernel, plain = check(dev, *case)
            except AssertionError:
                fail(f"{name}: {call}: {traceback.format_exc(limit=-1).strip()}")
            before = COUNTERS[name].launches
            kernel()
            launches = COUNTERS[name].launches - before
            ms = time_ms(kernel, reps=5, samples=3)
            plain_ms = time_ms(plain, reps=1, samples=3, warm=1)
            log(f"  {name} {call}: within its tolerance, its control outside; "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} launches a call {launches}")
            res[name].append({"call": call, "ms": ms, "plain_ms": plain_ms,
                              "launches_a_call": launches})
            del kernel, plain
            torch.cuda.empty_cache()
    return res


# phase 3: serving end to end
# ----------------------------------------------------------------------------


def zero_launches(**counts) -> dict:
    return {**{name: 0 for name in COUNTERS}, **counts}


# the two model families the port serves and trains: configuration, launches
# per serving forward and per train step, and the controls their checks reject
SWIN = {
    "label": "Swin-Base/224", "config": FLAGSHIP, "profile_prefix": "",
    "serve_launches": zero_launches(window_attention_fwd=24, gpf_fwd=1, subspace_isqrt_fwd=1),
    "train_launches": zero_launches(window_attention_fwd=24, window_attention_bwd=24,
                                    gpf_fwd=1, gpf_bwd=1),
    "serve_control": bias_omitted, "serve_control_name": "kernel without bias",
    "grad_control": bias_gradient_dropped, "grad_control_name": "bias gradient dropped",
    # batches at which the kernel path is held against the plain path
    "serve_check_batch": {torch.bfloat16: BATCH, torch.float32: 8},
    "train_check_batch": {torch.bfloat16: BATCH, torch.float32: 4},
    "ill_conditioned": TOL_GRADS_REL_ILL_CONDITIONED,
}
VIT = {
    "label": "ViT-Base/224", "config": VIT_FLAGSHIP, "profile_prefix": "vit_",
    "serve_launches": zero_launches(packed_attention_fwd=VIT_DEPTH, gpf_fwd=1,
                                    subspace_isqrt_fwd=1),
    "train_launches": zero_launches(packed_attention_fwd=VIT_DEPTH,
                                    packed_attention_bwd=VIT_DEPTH, gpf_fwd=1, gpf_bwd=1),
    "serve_control": only_first_keys_attended,
    "serve_control_name": "kernel attending the first 64 keys only",
    "grad_control": key_gradient_dropped, "grad_control_name": "dK dropped",
    "serve_check_batch": {torch.bfloat16: BATCH, torch.float32: 8},
    "train_check_batch": {torch.bfloat16: BATCH, torch.float32: 4},
    "ill_conditioned": TOL_GRADS_REL_ILL_CONDITIONED,
}
# Swin-Base/224 under backbone_attn_kernel 'fused_half': stages 0-1 (4 blocks)
# take the fused attention half, stages 2-3 (20 blocks) kernel 1
FH_FLAGSHIP = json.loads(json.dumps(FLAGSHIP))
FH_FLAGSHIP["model"]["backbone_attn_kernel"] = "fused_half"
N_FUSED = 4
SWIN_FH = {
    "label": "Swin-Base/224 fused_half", "config": FH_FLAGSHIP, "profile_prefix": "fused_",
    "serve_launches": zero_launches(attn_half_fwd=N_FUSED, window_attention_fwd=24 - N_FUSED,
                                    gpf_fwd=1, subspace_isqrt_fwd=1),
    "train_launches": zero_launches(attn_half_fwd=N_FUSED, attn_half_bwd=N_FUSED,
                                    window_attention_fwd=24 - N_FUSED,
                                    window_attention_bwd=24 - N_FUSED, gpf_fwd=1, gpf_bwd=1),
    "serve_control": fused_bias_omitted,
    "serve_control_name": "fused kernel without its bias",
    "grad_control": qkv_weight_gradient_dropped, "grad_control_name": "fused dwqkv dropped",
    "serve_check_batch": {torch.bfloat16: BATCH, torch.float32: 8},
    "train_check_batch": {torch.bfloat16: BATCH, torch.float32: 4},
    "ill_conditioned": TOL_GRADS_REL_ILL_CONDITIONED_FUSED,
    "default_config": FLAGSHIP,
}
# ViT-Base at 448: 785 tokens take kernel 6, and N = 784 >= D = 768 takes the
# moment head's dense route through kernel 5.  The plain path's attention
# holds [B, 12, 785, 785] fp32 probabilities (3.8 GB per tensor at 128
# images), so it is compared at small batches.
VIT448 = {
    "label": "ViT-Base/448", "config": VIT448_FLAGSHIP, "profile_prefix": "vit448_",
    "serve_launches": zero_launches(flash_attention_tiled_fwd=VIT_DEPTH, gpf_fwd=1,
                                    newton_schulz_isqrt_fp32_fwd=1),
    "train_launches": zero_launches(flash_attention_tiled_fwd=VIT_DEPTH,
                                    flash_attention_tiled_bwd=VIT_DEPTH, gpf_fwd=1, gpf_bwd=1,
                                    newton_schulz_isqrt_fp32_fwd=1),
    "serve_control": only_first_keys_attended_tiled,
    "serve_control_name": "first 64 keys attended only",
    "grad_control": key_gradient_dropped_tiled, "grad_control_name": "dK dropped",
    "serve_check_batch": {torch.bfloat16: 8, torch.float32: 2},
    "train_check_batch": {torch.bfloat16: 8, torch.float32: 2},
    "ill_conditioned": TOL_GRADS_REL_ILL_CONDITIONED_448,
    "coefficient_witness": True,
}
# ViT-Large at 512: 1025 tokens take kernel 6 (16 heads of 64), and N = D =
# 1024 the dense route through kernel 5′ (the bf16 Newton–Schulz variant),
# trained under block checkpointing.  The plain path's attention holds
# [B, 16, 1025, 1025] fp32 probabilities, so it is compared at small batches.
# The GPF coefficients at N = 1024 are held as an ill-conditioned leaf, as at
# 448, without the fp64 witness.
VITL512 = {
    "label": "ViT-Large/512", "config": VITL512_FLAGSHIP, "profile_prefix": "vitL512_",
    "serve_launches": zero_launches(flash_attention_tiled_fwd=VITL_DEPTH, gpf_fwd=1,
                                    newton_schulz_isqrt_bf16_fwd=1),
    # block checkpointing runs each block's forward again in the backward
    "train_launches": zero_launches(flash_attention_tiled_fwd=2 * VITL_DEPTH,
                                    flash_attention_tiled_bwd=VITL_DEPTH, gpf_fwd=1, gpf_bwd=1,
                                    newton_schulz_isqrt_bf16_fwd=1),
    "serve_control": only_first_keys_attended_tiled,
    "serve_control_name": "first 64 keys attended only",
    "grad_control": key_gradient_dropped_tiled, "grad_control_name": "dK dropped",
    "serve_check_batch": {torch.bfloat16: 8, torch.float32: 2},
    "train_check_batch": {torch.bfloat16: 8, torch.float32: 2},
    "ill_conditioned": TOL_GRADS_REL_ILL_CONDITIONED_VITL,
}
# Swin-Large at 1280, served: 24 window-attention launches on padded canvases
# (heads of 32), GPF at [64, 1600, 1536], the dense route through kernel 5″.
# Two controls: the bias omitted, and the pad sentinel removed from the masks.
SWINL1280 = {
    "label": "Swin-Large/1280", "config": SWINL1280_FLAGSHIP, "profile_prefix": "swinL1280_",
    "serve_launches": zero_launches(window_attention_fwd=24, gpf_fwd=1,
                                    newton_schulz_isqrt_bf16_streamed_fwd=1),
    "serve_control": bias_omitted, "serve_control_name": "kernel without bias",
    "extra_serve_controls": [(pad_sentinel_removed, "pad sentinel removed from the masks")],
    "serve_check_batch": {torch.bfloat16: 8, torch.float32: 2},
}


# EVA-02-Large/14 at 448, served: the plain path holds [B, 16, 1025, 1025]
# fp32 probabilities, so it is compared at small batches; its bf16 logits are
# held by relative L2 (TOL_EVA_LOGITS_REL)
EVA448 = {
    "label": "EVA-02-Large/448", "config": EVA448_FLAGSHIP, "profile_prefix": "eva448_",
    "serve_launches": zero_launches(flash_attention_tiled_fwd=VITL_DEPTH, gpf_fwd=1,
                                    newton_schulz_isqrt_bf16_fwd=1, swiglu_norm_fwd=VITL_DEPTH),
    "serve_control": swiglu_gate_and_value_swapped,
    "serve_control_name": "SwiGLU glue with gate and value swapped",
    "serve_check_batch": {torch.bfloat16: 8, torch.float32: 2},
    "logits_rel_l2": TOL_EVA_LOGITS_REL,
}


def family_inputs(family: dict, g: torch.Generator):
    """The family's augmentation and a seeded uint8 batch at its resize size."""
    data = family["config"]["data"]
    aug = AugmentConfig(input_size=data["input_size"], resize_size=data["resize_size"])
    size = data["resize_size"]
    images = torch.randint(0, 256, (BATCH, size, size, 3), generator=g, device="cuda",
                           dtype=torch.uint8)
    return aug, images


def in_turns(runs: dict, reps: int) -> dict:
    """Host-clock seconds per call of each of two callables, timed in turns
    (a, b, b, a, a, b) so that drift of the shared host hits both alike:
    {name: median seconds}."""
    (na, fa), (nb, fb) = runs.items()
    times = {na: [], nb: []}
    for name, fn in ((na, fa), (nb, fb), (nb, fb), (na, fa), (na, fa), (nb, fb)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t) / reps)
    return {name: statistics.median(v) for name, v in times.items()}


def host_ms_in_turns(runs: dict, steps: int) -> dict:
    """Host milliseconds from each call to its return, before the
    synchronize that follows it, for ``steps`` calls of each of two
    callables in turns (a, b, b, a; steps / 2 calls a turn), the device
    drained before every call: {name: (median, min, max)}.  Without a
    profiler attached this is the dispatch the call costs the host (and any
    wait the call itself makes on the device)."""
    (na, fa), (nb, fb) = runs.items()
    times = {na: [], nb: []}
    for name, fn in ((na, fa), (nb, fb), (nb, fb), (na, fa)):
        for _ in range(steps // 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return {name: (statistics.median(v), min(v), max(v)) for name, v in times.items()}


def default_twin(model, family: dict, dtype=torch.bfloat16):
    """The default path's model on the same weights as ``model``."""
    cfg = json.loads(json.dumps(family["default_config"]))
    if dtype == torch.float32:
        cfg["model"]["bf16"] = False
        cfg["model"]["moment"]["bf16_params"] = False
    default = create_model(cfg, num_classes=80, device="cuda", seed=0)
    default.load_state_dict(model.state_dict())
    return default, cfg


def against_default(model, family: dict, aug, images, out, dtype) -> float:
    """The family's path against the default path on the same weights and
    images: the logits' relative L2 distance (bf16) or largest difference
    over max |logit| (fp32), which must lie within TOL_FUSED_VS_DEFAULT."""
    default, _ = default_twin(model, family, dtype)
    ref = make_infer_fn(default, aug)(images).float()
    torch.cuda.synchronize()
    out = out.float()
    if dtype == torch.bfloat16:
        err, what = ((out - ref).norm() / ref.norm()).item(), "relative L2"
    else:
        err, what = (out - ref).abs().max().item() / max(1.0, ref.abs().max().item()), \
            "of max |logit|"
    tol = TOL_FUSED_VS_DEFAULT[dtype]
    log(f"  {str(dtype)[6:]} logits (batch {images.shape[0]}) {family['label']} vs the default "
        f"path on the same weights: {err:.4e} {what} (tol {tol})")
    if not err <= tol:
        fail(f"{family['label']} {dtype} logits are {err} ({what}) from the default path's")
    del default
    return err


def serve(card: str, profile_dir: str | None, family: dict) -> dict:
    dev = torch.device("cuda")
    config = family["config"]
    g = torch.Generator(device=dev).manual_seed(0)
    aug, images = family_inputs(family, g)

    t0 = time.time()
    model = create_model(config, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model, g)
    infer = make_infer_fn(model, aug)
    logits = infer(images)
    torch.cuda.synchronize()
    log(f"  model built and first forward in {time.time() - t0:.1f} s")

    reset_launches()
    logits = infer(images)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"  launches in one forward: {launches}")
    if launches != family["serve_launches"]:
        fail(f"expected launches {family['serve_launches']} per forward, got {launches}")
    if tuple(logits.shape) != (BATCH, 80) or not torch.isfinite(logits).all():
        fail(f"logits shape {tuple(logits.shape)} or non-finite values")

    nb = family["serve_check_batch"][torch.bfloat16]
    sub = images[:nb]
    out = logits if nb == BATCH else infer(sub)
    with plain_kernels():
        ref = infer(sub)
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())

    def apart(logits):
        """(max |logits - ref|, relative L2, the reading held to tol)."""
        diff = logits.float() - ref.float()
        e, r = diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()
        return e, r, r if "logits_rel_l2" in family else e / scale
    tol = family.get("logits_rel_l2", TOL_LOGITS_REL[torch.bfloat16])
    err, rel, reading = apart(out)
    log(f"  bf16 logits (batch {nb}) kernel vs plain: max_abs_err={err:.4e} "
        f"({err / scale:.4e} of max |logit| {scale:.4e}), relative L2 {rel:.4e}; tol {tol} "
        f"{'relative L2' if 'logits_rel_l2' in family else 'x max'}")
    if reading > tol:
        fail("bf16 serving logits disagree with the plain path")
    controls = [(family["serve_control"], family["serve_control_name"]),
                *family.get("extra_serve_controls", [])]
    for control, name in controls:
        with control(model):
            ctrl = infer(sub)
        torch.cuda.synchronize()
        err_ctrl, rel_ctrl, reading_ctrl = apart(ctrl)
        log(f"  control ({name}): {err_ctrl:.4e} ({err_ctrl / scale:.4e} of max |logit|), "
            f"relative L2 {rel_ctrl:.4e}")
        if reading_ctrl <= tol:
            fail(f"bf16 serving check passes its control ({name})")
    vs_default = {}
    if family.get("default_config"):
        vs_default["bf16"] = against_default(model, family, aug, images, logits, torch.bfloat16)

    torch.cuda.reset_peak_memory_stats()
    rates = []
    n_batches = 10
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_batches):
            infer(images)
        torch.cuda.synchronize()
        rates.append(BATCH * n_batches / (time.perf_counter() - t))
    peak = torch.cuda.max_memory_allocated() / 2**30
    ips = statistics.median(rates)
    log(f"  serving images/s = {ips:.1f} (loops: {', '.join(f'{r:.1f}' for r in rates)}), "
        f"peak memory {peak:.2f} GiB, batch {BATCH}, on {card}")
    turns = None
    if family.get("default_config"):  # the two paths' serving speed, timed in turns
        infer_d = make_infer_fn(default_twin(model, family)[0], aug)
        sec = in_turns({"default": lambda: infer_d(images), "fused": lambda: infer(images)},
                       n_batches)
        turns = {k: BATCH / v for k, v in sec.items()}
        log(f"  serving images/s in turns (default, fused, fused, default, default, fused; "
            f"medians): default path {turns['default']:.1f}, {family['label']} "
            f"{turns['fused']:.1f}")
        del infer_d

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                infer(images)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        name = family["profile_prefix"] + "serving_profile.txt"
        with open(os.path.join(profile_dir, name), "w") as f:
            f.write(f"{card}\n{family['label']}, batch {BATCH}, 3 forwards\n{table}\n")
        log(f"  profile written to {profile_dir}/{name}")

    del model, infer, logits, out, ref, ctrl
    torch.cuda.empty_cache()

    # fp32 at a small batch: kernel vs plain with a tight tolerance
    nf = family["serve_check_batch"][torch.float32]
    f32_cfg = json.loads(json.dumps(config))
    f32_cfg["model"]["bf16"] = False
    f32_cfg["model"]["moment"]["bf16_params"] = False
    model32 = create_model(f32_cfg, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model32, torch.Generator(device=dev).manual_seed(0))
    infer32 = make_infer_fn(model32, aug)
    out32 = infer32(images[:nf])
    with plain_kernels():
        ref32 = infer32(images[:nf])
    torch.cuda.synchronize()
    err32 = (out32 - ref32).abs().max().item()
    scale32 = max(1.0, ref32.abs().max().item())
    log(f"  fp32 logits (batch {nf}) kernel vs plain: max_abs_err={err32:.4e}, max |logit|="
        f"{scale32:.4e} (tol {TOL_LOGITS_REL[torch.float32]} x max)")
    if not torch.isfinite(out32).all() or err32 > TOL_LOGITS_REL[torch.float32] * scale32:
        fail("fp32 serving logits disagree with the plain path")
    if family.get("default_config"):
        vs_default["fp32"] = against_default(model32, family, aug, images[:nf], out32,
                                             torch.float32)
    return {"launches": launches, "images_per_s": ips, "peak_gib": peak,
            "vs_default": vs_default, "turns": turns, "logits_max_abs_err": err,
            "logits_rel_l2": rel}


# ----------------------------------------------------------------------------
# phase 4: training end to end
# ----------------------------------------------------------------------------


def step_gradients(model, anchor, positive, labels, batch_stats: bool = False) -> dict:
    """One forward + backward on fixed views, dropout off: {leaf: gradient}.
    ``batch_stats``: the BatchNorms normalize with the batch's statistics, as
    a training step does (their running statistics restored after)."""
    model.eval()  # dropout off; gradients still flow
    norms = batch_norms(model) if batch_stats else []
    saved = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    for m in norms:
        m.train()
    model.zero_grad(set_to_none=True)
    model(anchor, positive, labels)["loss"].backward()
    torch.cuda.synchronize()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        for m, (mean, var) in zip(norms, saved):
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
    model.eval()
    return grads


def worst_leaf(grads: dict, ref: dict, dtype, ill: dict, zero: dict | None = None,
               bars: dict = TOL_GRADS_REL) -> tuple[float, str, float]:
    """Over the leaves, the largest ||g - g_ref|| / ||g_ref|| as a multiple of
    the leaf's tolerance (``ill`` for the ill-conditioned leaves), with the
    leaf and its relative error.  A leaf of ``zero`` ({leaf: its layer's
    weight}) has zero gradient in exact arithmetic: its ||g|| over that
    weight's ||g_ref|| is held to TOL_ZERO_GRAD (finite, in bf16)."""
    zero = zero or {}
    worst, where, worst_rel = 0.0, "", 0.0
    for name, r in ref.items():
        r32 = r.float()
        if name in zero:
            denom = ref[zero[name]].float().norm().item()
            rel = grads[name].float().norm().item() / max(denom, 1e-30)
            tol = TOL_ZERO_GRAD[dtype]
        else:
            denom = r32.norm().item()
            rel = (grads[name].float() - r32).norm().item() / max(denom, 1e-30)
            tol = ill.get(name, {}).get(dtype, bars[dtype])
        if not math.isfinite(rel):
            return math.inf, name, math.inf
        if rel / tol > worst:
            worst, where, worst_rel = rel / tol, name, rel
    return worst, where, worst_rel


def check_gradients(model, anchor, positive, labels, dtype, what: str, family: dict) -> float:
    bs = family.get("batch_stats", False)
    grads = step_gradients(model, anchor, positive, labels, bs)
    with plain_kernels():
        ref = step_gradients(model, anchor, positive, labels, bs)
    with family["grad_control"]():
        ctrl = step_gradients(model, anchor, positive, labels, bs)
    bars = family.get("grads_rel", TOL_GRADS_REL)
    tol = bars[dtype]
    ill = family["ill_conditioned"]
    zero = family.get("zero_grad_leaves", {})
    worst, where, rel = worst_leaf(grads, ref, dtype, ill, zero, bars)
    worst_ctrl, where_ctrl, rel_ctrl = worst_leaf(ctrl, ref, dtype, ill, zero, bars)
    _, where_well, rel_well = worst_leaf(grads, {k: v for k, v in ref.items() if k not in ill},
                                         dtype, {}, zero, bars)
    log(f"  {what} gradients kernel vs plain, {len(ref)} leaves: worst err/tol {worst:.4f} "
        f"(relative error {rel:.4e}) at {where}, among the well-conditioned leaves "
        f"{rel_well:.4e} at {where_well}; control ({family['grad_control_name']}) err/tol "
        f"{worst_ctrl:.2f} (relative error {rel_ctrl:.4e}) at {where_ctrl}; tol {tol} per leaf, "
        f"{ill} apart")
    if worst > 1.0:
        ranked = sorted(((worst_leaf(grads, {k: v}, dtype, ill, bars=bars)[0], k)
                         for k, v in ref.items() if k not in zero), reverse=True)[:6]
        log(f"  the worst leaves (err/tol): {', '.join(f'{k} {e:.3f}' for e, k in ranked)}")
        fail(f"{what} gradients of the kernel path disagree with the plain path")
    if worst_ctrl <= 1.0:
        fail(f"{what} gradient check passes its control ({family['grad_control_name']})")
    return rel


def coefficient_gradient_witness(model32, images, labels, aug, family: dict) -> list:
    """The fp32 gradient of ``gpf.alpha_coeffs`` at batch 2, kernel path and
    plain path, against the plain path run in fp64 on the same weights and
    views, for each of COEFF_WITNESS_SEEDS' views, with both planted dc
    faults: relative L2 distances to the fp64 gradient.  Fails unless both
    fp32 paths lie within the leaf's fp32 tolerance of it and both faults
    beyond."""
    leaf = "gpf.alpha_coeffs"
    nf = family["train_check_batch"][torch.float32]
    tol = family["ill_conditioned"][leaf][torch.float32]
    model64 = create_model(family["config"], num_classes=80, device="cuda", seed=0,
                           dtype=torch.float64)
    model64.load_state_dict(model32.state_dict())

    def leaf_grad(model, anchor, positive):
        return step_gradients(model, anchor, positive, labels[:nf])[leaf].double()

    rows = []
    for seed in COEFF_WITNESS_SEEDS:
        with torch.no_grad():
            anchor, positive = dual_view_train_batch(
                images[:nf], torch.Generator(device=images.device).manual_seed(seed), aug)
        kernel = leaf_grad(model32, anchor, positive)
        with plain_kernels():
            plain = leaf_grad(model32, anchor, positive)
            exact = leaf_grad(model64, anchor.double(), positive.double())
        faults = {}
        for fault in ("tail", "bf16"):
            with coefficient_gradient_faulted(fault):
                faults[fault] = leaf_grad(model32, anchor, positive)

        def rel(x, ref=exact):
            return ((x - ref).norm() / ref.norm()).item()

        row = {"seed": seed, "kernel": rel(kernel), "plain": rel(plain),
               "kernel_vs_plain": rel(kernel, plain),
               **{f"fault_{k}": rel(v) for k, v in faults.items()}}
        rows.append(row)
        log(f"  {leaf} fp32 gradient vs the fp64 plain path, batch {nf}, views seed {seed}: "
            f"kernel path {row['kernel']:.4e}, plain path {row['plain']:.4e} (kernel vs plain "
            f"{row['kernel_vs_plain']:.4e}); planted faults: last token tile skipped "
            f"{row['fault_tail']:.4e}, cotangent in bf16 {row['fault_bf16']:.4e}; tol {tol}")
    del model64
    if max(max(r["kernel"], r["plain"]) for r in rows) > tol:
        fail(f"an fp32 {leaf} gradient is further than {tol} from the fp64 one")
    if min(min(r["fault_tail"], r["fault_bf16"]) for r in rows) <= tol:
        fail(f"a planted dc fault reads within the {leaf} tolerance {tol}")
    return rows


def train(card: str, profile_dir: str | None, family: dict) -> dict:
    dev = torch.device("cuda")
    config = family["config"]
    g = torch.Generator(device=dev).manual_seed(0)
    aug, images = family_inputs(family, g)
    labels = torch.randint(0, 80, (BATCH,), generator=g, device=dev)

    t0 = time.time()
    model = create_model(config, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model, g)
    state = create_train_state(model, config, TRAIN_STEPS_PER_EPOCH)
    train_step = make_train_step(model, aug)
    seed_gen = torch.Generator(device=dev).manual_seed(1)
    log(f"  model and train state built in {time.time() - t0:.1f} s; factored leaves "
        f"{state.optimizer.factored}, fp32 masters for {len(state.optimizer.master)} bf16 "
        f"leaves of {len(state.optimizer.names)}")

    # one step's gradients, kernels vs plain versions, before any update
    nb = family["train_check_batch"][torch.bfloat16]
    with torch.no_grad():
        anchor, positive = dual_view_train_batch(
            images[:nb], torch.Generator(device=dev).manual_seed(2), aug)
    grad_err = check_gradients(model, anchor, positive, labels[:nb], torch.bfloat16,
                               f"bf16 batch {nb}", family)
    del anchor, positive
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    losses = []
    n_steps = 10
    for i in range(n_steps):
        reset_launches()
        loss = train_step(state, images, labels, seed_gen)
        torch.cuda.synchronize()
        launches = read_launches()
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            fail(f"loss at step {i} is not finite: {losses[-1]}")
        want = family["train_launches"]
        if launches != want:
            fail(f"step {i}: expected launches {want}, got {launches}")
    log(f"  launches in one train step: {launches}")
    log(f"  losses over {n_steps} steps on one batch: {', '.join(f'{x:.4f}' for x in losses)}; "
        f"last grad norm {state.optimizer.last_grad_norm:.3f}")
    if losses[-1] >= losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    if state.optimizer.total_notfinite != 0 or state.step != n_steps:
        fail(f"{state.optimizer.total_notfinite} non-finite steps were skipped "
             f"(step count {state.step})")
    for name, p in model.named_parameters():
        if not torch.isfinite(p).all():
            fail(f"parameter {name} is not finite after {n_steps} steps")

    rates, step_ms = [], []
    n_timed = family.get("timed_steps", 5)
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n_timed):
            train_step(state, images, labels, seed_gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        rates.append(BATCH * n_timed / dt)
        step_ms.append(dt / n_timed * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ips = statistics.median(rates)
    log(f"  train images/s = {ips:.1f} (loops: {', '.join(f'{r:.1f}' for r in rates)}), step ms "
        f"{statistics.median(step_ms):.1f} (loops: {', '.join(f'{m:.1f}' for m in step_ms)}), "
        f"peak memory {peak:.2f} GiB, batch {BATCH} ({TRAIN_VIEWS} images through the "
        f"backbone), on {card}")
    turns = None
    if family.get("default_config"):  # the two paths' step time, timed in turns
        default, cfg_d = default_twin(model, family)
        state_d = create_train_state(default, cfg_d, TRAIN_STEPS_PER_EPOCH)
        step_d = make_train_step(default, aug)
        sec = in_turns({"default": lambda: step_d(state_d, images, labels, seed_gen),
                        "fused": lambda: train_step(state, images, labels, seed_gen)}, 3)
        turns = {k: v * 1e3 for k, v in sec.items()}
        log(f"  train step ms in turns (default, fused, fused, default, default, fused; "
            f"medians): default path {turns['default']:.1f}, {family['label']} "
            f"{turns['fused']:.1f}")
        host = host_ms_in_turns({"default": lambda: step_d(state_d, images, labels, seed_gen),
                                 "fused": lambda: train_step(state, images, labels, seed_gen)},
                                20)
        turns["host"] = host
        log(f"  host ms a train step, call to return before synchronize, no profiler, in turns "
            f"(default, fused, fused, default; 20 steps each; median, min, max): default path "
            f"{host['default'][0]:.1f} ({host['default'][1]:.1f}, {host['default'][2]:.1f}), "
            f"{family['label']} {host['fused'][0]:.1f} ({host['fused'][1]:.1f}, "
            f"{host['fused'][2]:.1f})")
        del default, state_d, step_d
        torch.cuda.empty_cache()

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                train_step(state, images, labels, seed_gen)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
        name = family["profile_prefix"] + "training_profile.txt"
        with open(os.path.join(profile_dir, name), "w") as f:
            f.write(f"{card}\n{family['label']}, batch {BATCH}, 2 train steps\n{table}\n")
        log(f"  profile written to {profile_dir}/{name}")

    del model, state, train_step, loss
    torch.cuda.empty_cache()

    # fp32 at a small batch: kernel-path vs plain-path gradients with a tight
    # tolerance
    nf = family["train_check_batch"][torch.float32]
    f32_cfg = json.loads(json.dumps(config))
    f32_cfg["model"]["bf16"] = False
    f32_cfg["model"]["moment"]["bf16_params"] = False
    model32 = create_model(f32_cfg, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model32, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        anchor, positive = dual_view_train_batch(
            images[:nf], torch.Generator(device=dev).manual_seed(2), aug)
    grad_err32 = check_gradients(model32, anchor, positive, labels[:nf], torch.float32,
                                 f"fp32 batch {nf}", family)
    del anchor, positive
    witness = (coefficient_gradient_witness(model32, images, labels, aug, family)
               if family.get("coefficient_witness") else None)
    return {"launches": launches, "images_per_s": ips, "step_ms": statistics.median(step_ms),
            "peak_gib": peak, "losses": losses, "grad_err_bf16": grad_err, "turns": turns,
            "grad_err_f32": grad_err32, "coefficient_witness": witness}


# ----------------------------------------------------------------------------
# phase 6: the data pipeline, trainer, evaluator and checkpoints
# ----------------------------------------------------------------------------

# run outputs (logs, checkpoints of ~3.4 GB each, results.json), inside the
# checkout and git-ignored; removed when the phase ends
ENGINE_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke_engine"
ENGINE_TTA_SCALES = (0.9, 1.0)
ENGINE_BIAS_SEED = 7
ENGINE_EPOCH_STEPS = 10  # 640 train images, batch 64, drop_last


def engine_config(tag: str, device_cache: bool, save_frequency: int = 1) -> dict:
    """The flagship configuration on the synthetic dataset (80 classes x 8
    images a split at resize 256, a class signal under the noise: on pure
    noise two epochs collapse the model to one class and its logits to
    constants), two epochs, validation and checkpoints every epoch, TTA at
    0.9 and 1.0, the ablations on."""
    cfg = json.loads(json.dumps(FLAGSHIP))
    cfg["dataset"] = {"name": "synthetic", "num_classes": 80, "samples_per_class": 8,
                      "learnable": True}
    cfg["data"].update({"device_cache": "true" if device_cache else "false",
                        "host_cache": "true", "num_workers": 8})
    cfg["training"].update({"epochs": 2, "val_frequency": 1, "save_frequency": save_frequency})
    cfg["experiment"] = {"name": f"chip_smoke_{tag}", "seed": 0, "log_frequency": 1000,
                         **{k: str(ENGINE_DIR / tag / k)
                            for k in ("output_dir", "save_dir", "log_dir")}}
    cfg["evaluation"] = {"tta": {"enabled": True, "scales": list(ENGINE_TTA_SCALES)}}
    cfg["ablation"] = {"enabled": True}
    return cfg


class BatchHash:
    """A batch's fingerprint on the device: the images' and the labels' sums
    under fixed positional weights, int64, on the stream that reads them."""

    def __init__(self):
        self.w = None

    def __call__(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        flat = images.reshape(-1)
        if self.w is None or self.w.numel() < flat.numel():
            idx = torch.arange(flat.numel(), device=flat.device, dtype=torch.int64)
            self.w = (idx * 2654435761) % 1000003 + 1
        return torch.stack([(flat.long() * self.w[:flat.numel()]).sum(),
                            (labels.long() * self.w[:labels.numel()]).sum()])


def record_steps(trainer) -> dict:
    """Wrap the trainer's step and its epoch: per step the batch's hash (on
    the stream the step reads it from), the launch counts (set to 0 just
    before the step, read just after) and the loss, kept on the device; per
    epoch what ``train_epoch`` returned."""
    rec = {"hash": [], "launches": [], "loss": [], "epochs": []}
    step, epoch_fn, hasher = trainer._train_step, trainer.train_epoch, BatchHash()

    def wrapped_step(state, images, labels, generator):
        rec["hash"].append(hasher(images, labels))
        reset_launches()
        metrics = step(state, images, labels, generator)
        rec["launches"].append(read_launches())
        rec["loss"].append(metrics["loss"])
        return metrics

    def wrapped_epoch(epoch):
        out = epoch_fn(epoch)
        rec["epochs"].append(out)
        return out

    trainer._train_step = wrapped_step
    trainer.train_epoch = wrapped_epoch
    return rec


def check_steps(rec: dict, what: str) -> list:
    """Every step's loss finite and every step's launches the Swin train
    step's (24 + 24 window attention, 1 + 1 GPF); returns the losses."""
    losses = torch.stack(rec["loss"]).tolist()
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: a step's loss is not finite: {losses}")
    want = SWIN["train_launches"]
    for i, got in enumerate(rec["launches"]):
        if got != want:
            fail(f"{what}: step {i} launched {got}, expected {want}")
    return losses


class OneBufferPrefetcher(_pipeline.DevicePrefetcher):
    """Control for the host-loader check: one pinned buffer and one device
    buffer for every batch, the next batch copied in on the side stream
    while the step may still read the last, and no wait on the consumer's
    stream.  The batch check must see it."""

    def __iter__(self):
        side = torch.cuda.Stream()
        bufs = {}

        def produce(put):
            for batch in self.host_iter:
                if not bufs:
                    bufs["pinned"] = [torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                                                  pin_memory=True) for x in batch]
                    bufs["dev"] = [torch.empty_like(p, device="cuda") for p in bufs["pinned"]]
                for p, x in zip(bufs["pinned"], batch):
                    p.copy_(torch.from_numpy(x))
                with torch.cuda.stream(side):
                    for d, p in zip(bufs["dev"], bufs["pinned"]):
                        d.copy_(p, non_blocking=True)
                if not put(tuple(bufs["dev"])):
                    return

        yield from _pipeline._background(produce, self.depth)


def params_on_host(model) -> dict:
    return {n: p.detach().cpu() for n, p in model.named_parameters()}


def differing_leaves(model, ref: dict) -> list:
    return [n for n, p in model.named_parameters() if not torch.equal(p.detach().cpu(), ref[n])]


def engine(card: str) -> dict:
    dev = torch.device("cuda")
    shutil.rmtree(ENGINE_DIR, ignore_errors=True)

    def build(tag: str, device_cache: bool, save_frequency: int = 1) -> Trainer:
        t0 = time.time()
        tr = Trainer(engine_config(tag, device_cache, save_frequency))
        tr.setup_data()
        tr.setup_model()
        # tables at the std trained ones reach, so that the evaluator's
        # bias-omitted control moves the logits
        redraw_bias_tables(tr.model, torch.Generator(device=dev).manual_seed(ENGINE_BIAS_SEED))
        loader = tr.train_loader
        log(f"  {tag}: trainer set up in {time.time() - t0:.1f} s; train data "
            f"{type(loader).__name__}"
            + (f" over {type(loader.dataset).__name__}" if hasattr(loader, "dataset") else "")
            + f", {len(loader)} batches of {BATCH}")
        return tr

    # [6a] device-cache training: two epochs with validation and checkpoints
    torch.cuda.reset_peak_memory_stats()
    t1 = build("device_cache", True)
    if not isinstance(t1.train_loader, DeviceDatasetCache):
        fail("device_cache: true did not give the device cache")
    rec1 = record_steps(t1)
    save_s = []
    save = _trainer_module.save_checkpoint

    def timed_save(*args, **kwargs):
        t = time.perf_counter()
        save(*args, **kwargs)
        save_s.append(time.perf_counter() - t)

    _trainer_module.save_checkpoint = timed_save
    t0 = time.time()
    try:
        out1 = t1.train()
    finally:
        _trainer_module.save_checkpoint = save
    train_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses1 = check_steps(rec1, "device-cache training")
    if len(losses1) != 2 * ENGINE_EPOCH_STEPS:
        fail(f"device-cache training took {len(losses1)} steps, expected {2 * ENGINE_EPOCH_STEPS}")
    ckpts = Path(t1.ckpt_dir)
    for name in ("checkpoint_epoch_0", "checkpoint_epoch_1", "best_model"):
        if not ((ckpts / name / "model.pt").exists() and (ckpts / name / "optimizer.pt").exists()
                and (ckpts / f"{name}.meta.json").exists()):
            fail(f"the trainer wrote no {name} with its .meta.json")
    ips_dc = [e["images_per_sec"] for e in rec1["epochs"]]
    ckpt_gb = sum(f.stat().st_size for f in (ckpts / "checkpoint_epoch_0").iterdir()) / 1e9
    log(f"  checkpoint writes: {', '.join(f'{x:.2f}' for x in save_s)} s ({ckpt_gb:.2f} GB "
        f"each)")
    log(f"  device cache, 2 epochs in {train_s:.1f} s (with validation and {len(save_s)} "
        f"checkpoint writes): train loss {out1['history']['train_loss']}, val acc "
        f"{out1['history']['val_acc']}, best {out1['best_val_acc']:.4f}; every step's loss finite "
        f"and launches {rec1['launches'][0]}; peak memory {peak:.2f} GiB")
    log(f"  train_epoch images/s, device cache: epoch 0 {ips_dc[0]:.1f}, epoch 1 {ips_dc[1]:.1f} "
        f"(batch {BATCH}, on {card})")
    params1 = params_on_host(t1.model)
    epoch0_loss = rec1["epochs"][0]["loss"]
    hashes0 = torch.stack(rec1["hash"][:ENGINE_EPOCH_STEPS])
    best = str(ckpts / "best_model")
    ckpt0 = str(ckpts / "checkpoint_epoch_0")
    del t1, rec1
    torch.cuda.empty_cache()

    # [6b] resume from epoch 0 and run epoch 1: the uninterrupted parameters,
    # bit for bit; the optimizer's moments zeroed must miss them
    t2 = build("resumed", True, save_frequency=1000)
    t0 = time.perf_counter()
    t2.resume(ckpt0)
    restore_s = time.perf_counter() - t0
    if t2.start_epoch != 1 or t2.state.step != ENGINE_EPOCH_STEPS:
        fail(f"resume gave start_epoch {t2.start_epoch}, step {t2.state.step}")
    rec2 = record_steps(t2)
    t2.train()
    check_steps(rec2, "resumed training")
    differ = differing_leaves(t2.model, params1)
    log(f"  resumed at epoch 1 from checkpoint_epoch_0 (restored in {restore_s:.2f} s): "
        f"{len(params1) - len(differ)} of {len(params1)} parameter leaves equal the "
        f"uninterrupted run's bit for bit")
    if differ:
        fail(f"resumed parameters differ from the uninterrupted run's at {differ[:5]}")
    del t2
    torch.cuda.empty_cache()
    t3 = build("resumed_zeroed", True)
    t3.resume(ckpt0)
    opt = t3.state.optimizer
    with torch.no_grad():
        for group in (opt.m, opt.v, opt.ema, opt.v_row, opt.v_col):
            for t in group.values():
                t.zero_()
    t3.train_epoch(1)
    differ_ctrl = differing_leaves(t3.model, params1)
    log(f"  control (resumed with the optimizer's moments zeroed): {len(differ_ctrl)} of "
        f"{len(params1)} leaves differ")
    if not differ_ctrl:
        fail("the resume check passes its control (moments zeroed)")
    del t3, opt
    torch.cuda.empty_cache()

    # [6c] host loader: HostDecodedCache -> BatchLoader -> DevicePrefetcher;
    # the batches and the epoch's loss of the device cache, bit for bit
    t4 = build("host_loader", False)
    if not (isinstance(t4.train_loader, BatchLoader)
            and isinstance(t4.train_loader.dataset, HostDecodedCache)):
        fail("device_cache: false did not give the host loader over the host cache")
    rec4 = record_steps(t4)
    m4 = t4.train_epoch(0)
    check_steps(rec4, "host-loader training")
    same = (torch.stack(rec4["hash"]) == hashes0).all(dim=1).tolist()
    log(f"  host loader epoch 0: {sum(same)} of {len(same)} batches equal the device cache's "
        f"(hash on the device); epoch loss {m4['loss']!r} against the device cache's "
        f"{epoch0_loss!r}")
    if len(same) != ENGINE_EPOCH_STEPS or not all(same):
        fail("the host loader's batches differ from the device cache's")
    if m4["loss"] != epoch0_loss:
        fail("the host loader's epoch loss differs from the device cache's")
    m4b = t4.train_epoch(1)
    ips_host = [m4["images_per_sec"], m4b["images_per_sec"]]
    log(f"  train_epoch images/s, host loader: epoch 0 {ips_host[0]:.1f}, epoch 1 "
        f"{ips_host[1]:.1f} (batch {BATCH}, on {card})")
    rec_ctrl = record_steps(t4)
    saved = _trainer_module.DevicePrefetcher
    _trainer_module.DevicePrefetcher = OneBufferPrefetcher
    try:
        t4.train_epoch(0)
    finally:
        _trainer_module.DevicePrefetcher = saved
    same_ctrl = (torch.stack(rec_ctrl["hash"]) == hashes0).all(dim=1).tolist()
    log(f"  control (one pinned buffer reused without waiting): {sum(same_ctrl)} of "
        f"{len(same_ctrl)} batches equal the device cache's")
    if all(same_ctrl):
        fail("the host-loader batch check passes its control (one buffer, no wait)")

    # [6d] the same step through make_train_step on a fixed batch (phase 4's
    # method), on the host-loader trainer's model
    g = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 256, (BATCH, 256, 256, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    labels = torch.randint(0, t4.num_classes, (BATCH,), generator=g, device=dev)
    step = make_train_step(t4.model, t4.aug_cfg)
    step(t4.state, images, labels, t4.train_generator)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            step(t4.state, images, labels, t4.train_generator)
        torch.cuda.synchronize()
        rates.append(BATCH * 5 / (time.perf_counter() - t))
    ips_step = statistics.median(rates)
    log(f"  make_train_step on a fixed batch: {ips_step:.1f} images/s (loops: "
        f"{', '.join(f'{r:.1f}' for r in rates)}; batch {BATCH}, on {card})")
    del t4, step, images, labels
    torch.cuda.empty_cache()

    # [6e] the evaluator on the best checkpoint: metrics, ablations, TTA
    ev = Evaluator(engine_config("eval", True), best)
    reset_launches()
    out = ev.evaluate(visualize=False, ablation=True)
    eval_launches = read_launches()
    m = out["metrics"]
    results = Path(ev.output_dir) / "results.json"
    log(f"  evaluator: top1 {m['top1_accuracy']:.4f}, top5 {m['top5_accuracy']:.4f}, TTA top1 "
        f"{m['tta_top1_accuracy']:.4f}, ablations {out['ablations']}; launches over the "
        f"evaluation {eval_launches}")
    if sorted(out["ablations"]) != ["cls_only", "no_gpf", "uniform_graph"] or not all(
            0.0 <= v <= 1.0 for v in out["ablations"].values()):
        fail(f"ablation accuracies {out['ablations']}")
    if not results.exists() or "tta_top1_accuracy" not in m:
        fail("the evaluator wrote no results.json or no TTA accuracy")
    if not (eval_launches["window_attention_fwd"] and eval_launches["gpf_fwd"]
            and eval_launches["subspace_isqrt_fwd"]):
        fail(f"the evaluation launched {eval_launches}")
    images_np, labels_np = next(iter(ev.loader))
    images = torch.from_numpy(images_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)

    def logits_check(evaluator, n: int, dtype, tol: float):
        """The evaluator's eval step on the first n images, kernels against
        the plain path and against the bias-omitted control: (error,
        control's error, the logits, max |logit|), errors over max |logit|."""
        out = evaluator._eval_step(images[:n], labels[:n])["logits"].float()
        with plain_kernels():
            ref = evaluator._eval_step(images[:n], labels[:n])["logits"].float()
        with bias_omitted(evaluator.model):
            ctrl = evaluator._eval_step(images[:n], labels[:n])["logits"].float()
        torch.cuda.synchronize()
        scale = max(1.0, ref.abs().max().item())
        err = (out - ref).abs().max().item() / scale
        err_ctrl = (ctrl - ref).abs().max().item() / scale
        log(f"  evaluator {str(dtype)[6:]} logits (batch {n}) vs the plain path: {err:.4e} of max "
            f"|logit| {scale:.4e}; control (bias omitted) {err_ctrl:.4e}; tol {tol}")
        if err > tol:
            fail(f"the evaluator's {dtype} logits disagree with the plain path")
        return err, err_ctrl, out, scale

    err, err_ctrl_bf16, logits, scale = logits_check(ev, BATCH, torch.bfloat16,
                                                     TOL_LOGITS_REL[torch.bfloat16])
    infer = make_infer_fn(ev.model, ev.aug_cfg)
    served = infer(images).float()
    err_serve = (served - logits).abs().max().item() / scale
    first = torch.from_numpy(ev.features["logits"][:BATCH]).to(dev)
    log(f"  make_infer_fn vs the evaluator, same images: {err_serve:.4e} of max |logit| (tol "
        f"{TOL_LOGITS_REL[torch.bfloat16]}); evaluate()'s own first-batch logits "
        f"{'equal' if torch.equal(first, logits) else 'differ from'} the eval step's")
    if err_serve > TOL_LOGITS_REL[torch.bfloat16]:
        fail("make_infer_fn's logits disagree with the evaluator's")
    # After two epochs the bias moves the bf16 logits by less than their bf16
    # noise (chip run: control 8.1e-3 of max |logit| against 6.0e-3 sound),
    # so the bias-omitted control is held on the same checkpoint in fp32
    # (TOL_EVAL_LOGITS_REL_FP32).
    cfg32 = engine_config("eval_fp32", True)
    cfg32["model"]["bf16"] = False
    cfg32["model"]["moment"]["bf16_params"] = False
    ev32 = Evaluator(cfg32, best)
    ev32.setup_data()
    ev32.load_model()
    err32, err_ctrl, _, _ = logits_check(ev32, 8, torch.float32, TOL_EVAL_LOGITS_REL_FP32)
    if err_ctrl <= TOL_EVAL_LOGITS_REL_FP32:
        fail("the evaluator logits check passes its control (bias omitted)")
    del ev32
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            infer(images)
        torch.cuda.synchronize()
        rates.append(BATCH * 10 / (time.perf_counter() - t))
    ips_infer = statistics.median(rates)
    log(f"  evaluator images/s {m['images_per_sec']:.1f} (compute_metrics, {m['num_samples']} "
        f"images) against make_infer_fn {ips_infer:.1f} (loops: "
        f"{', '.join(f'{r:.1f}' for r in rates)}; batch {BATCH}, on {card})")
    del ev, infer
    shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"step_launches": rec4["launches"][0], "eval_launches": eval_launches,
            "images_per_s": {"device_cache_epochs": ips_dc, "host_loader_epochs": ips_host,
                             "make_train_step": ips_step, "evaluator": m["images_per_sec"],
                             "make_infer_fn": ips_infer},
            "checkpoint_write_s": save_s, "checkpoint_gb": ckpt_gb, "restore_s": restore_s,
            "peak_gib": peak, "errors": {"eval_vs_plain_bf16": err,
                                         "eval_bias_omitted_bf16": err_ctrl_bf16,
                                         "eval_vs_plain_fp32": err32,
                                         "eval_bias_omitted_fp32": err_ctrl,
                                         "serve_vs_eval": err_serve}}


# ----------------------------------------------------------------------------
# phase 7: the remaining model, loss and training options
# ----------------------------------------------------------------------------

OPTIONS_BN = {
    "label": "Swin-Base/224 adaptive GPF + BatchNorm + adaptive classifier + accumulation 2",
    "config": OPTIONS_BN_FLAGSHIP,
    "grad_control": bias_gradient_dropped, "grad_control_name": "bias gradient dropped",
    "ill_conditioned": TOL_GRADS_REL_ILL_CONDITIONED_ADAPTIVE,
    "batch_stats": True,  # gradient checks normalize with the batch's statistics
    "zero_grad_leaves": ZERO_GRAD_LEAVES_BN,
    "grads_rel": TOL_GRADS_REL_BN,
}
VITL448_MS = {
    "label": "ViT-Large/448 multi-scale classifier", "config": VITL448_MS_FLAGSHIP,
    "profile_prefix": "vitL448_",
    "serve_launches": zero_launches(flash_attention_tiled_fwd=VITL_DEPTH, gpf_fwd=1,
                                    subspace_isqrt_fwd=1),
    "train_launches": zero_launches(flash_attention_tiled_fwd=2 * VITL_DEPTH,
                                    flash_attention_tiled_bwd=VITL_DEPTH, gpf_fwd=1, gpf_bwd=1),
    "serve_control": only_first_keys_attended_tiled,
    "serve_control_name": "first 64 keys attended only",
    "grad_control": key_gradient_dropped_tiled, "grad_control_name": "dK dropped",
    "serve_check_batch": {torch.bfloat16: 8, torch.float32: 2},
    "train_check_batch": {torch.bfloat16: 8, torch.float32: 2},
    "ill_conditioned": TOL_GRADS_REL_ILL_CONDITIONED_VITL,
    "zero_grad_leaves": ZERO_GRAD_LEAVES_MULTISCALE,
    # 10 steps, as ViT-Large/512's: over 5 its loss on one batch rose before
    # it fell (14.83, 15.57, 16.39, 15.31, 14.93 on an H100)
    "timed_steps": 2,
}


def batch_norms(model: torch.nn.Module) -> list:
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def running_stats(model: torch.nn.Module) -> list:
    return [t.clone() for m in batch_norms(model) for t in (m.running_mean, m.running_var)]


def params_snapshot(model: torch.nn.Module) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def unchanged(model: torch.nn.Module, snap: dict) -> bool:
    return all(torch.equal(p, snap[n]) for n, p in model.named_parameters())


def accumulation_pattern_ok(moved: list, k: int) -> bool:
    """Parameters bit for bit unmoved after each micro-step but every k-th,
    moved after every k-th."""
    return moved == [(i + 1) % k == 0 for i in range(len(moved))]


def timed_steps(fn, n: int) -> tuple[float, list]:
    """Median ms a call over two loops of ``n`` calls, and the loops' ms."""
    loops = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        loops.append((time.perf_counter() - t) / n * 1e3)
    return statistics.median(loops), loops


def options_batchnorm(card: str) -> dict:
    """Phase 7a: the flagship with adaptive GPF ('attention'), BatchNorm head
    norms, the adaptive classifier and two micro-steps an update."""
    dev = torch.device("cuda")
    cfg = OPTIONS_BN_FLAGSHIP
    k = cfg["training"]["accumulation_steps"]
    g = torch.Generator(device=dev).manual_seed(0)
    aug, images = family_inputs({"config": cfg}, g)
    labels = torch.randint(0, 80, (BATCH,), generator=g, device=dev)
    t0 = time.time()
    model = create_model(cfg, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model, g)
    log(f"  model built in {time.time() - t0:.1f} s; {len(batch_norms(model))} BatchNorms")

    # one update's gradients (batch statistics, dropout off), kernels vs plain
    with torch.no_grad():
        anchor, positive = dual_view_train_batch(images, torch.Generator(device=dev)
                                                 .manual_seed(2), aug)
    grad_err = check_gradients(model, anchor, positive, labels, torch.bfloat16,
                               f"bf16 batch {BATCH}", OPTIONS_BN)
    del anchor, positive

    state = create_train_state(model, cfg, TRAIN_STEPS_PER_EPOCH)
    step = make_train_step(model, aug)
    seed_gen = torch.Generator(device=dev).manual_seed(1)
    want = zero_launches(window_attention_fwd=24, window_attention_bwd=24)
    torch.cuda.reset_peak_memory_stats()
    moved, stats_moved, losses = [], [], []
    for i in range(OPTIONS_MICRO_STEPS):
        snap, stats = params_snapshot(model), running_stats(model)
        reset_launches()
        loss = step(state, images, labels, seed_gen)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != want:
            fail(f"7a micro-step {i}: expected launches {want}, got {launches}")
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            fail(f"7a micro-step {i}: the loss is not finite ({losses[-1]})")
        moved.append(not unchanged(model, snap))
        stats_moved.append(all(not torch.equal(a, b)
                               for a, b in zip(stats, running_stats(model))))
        del snap
    log(f"  launches a micro-step: {launches}")
    log(f"  losses over {OPTIONS_MICRO_STEPS} micro-steps: "
        f"{', '.join(f'{x:.4f}' for x in losses)}; parameters moved: {moved}; running "
        f"statistics moved: {stats_moved}; updates {state.optimizer.count}, skipped "
        f"{state.optimizer.total_notfinite}, last grad norm {state.optimizer.last_grad_norm:.3f}")
    if not accumulation_pattern_ok(moved, k):
        fail(f"7a: parameters moved after micro-steps {moved}, not after every {k}-th only")
    if not all(stats_moved):
        fail(f"7a: the running statistics did not move on every micro-step: {stats_moved}")
    if (state.optimizer.total_notfinite, state.optimizer.count, state.step) != (
            0, OPTIONS_MICRO_STEPS // k, OPTIONS_MICRO_STEPS):
        fail(f"7a: {state.optimizer.total_notfinite} skipped updates, {state.optimizer.count} "
             f"updates, step {state.step}")
    step_ms, loops = timed_steps(lambda: step(state, images, labels, seed_gen), 2 * k)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  train micro-step ms {step_ms:.1f} (loops: {', '.join(f'{x:.1f}' for x in loops)}), "
        f"images/s {BATCH / step_ms * 1e3:.1f}, peak memory {peak:.2f} GiB, batch {BATCH}, on "
        f"{card}")

    # controls: an update on every micro-step; a forward that leaves the
    # running statistics alone
    ctrl_cfg = json.loads(json.dumps(cfg))
    ctrl_cfg["training"]["accumulation_steps"] = 1
    state_ctrl = create_train_state(model, ctrl_cfg, TRAIN_STEPS_PER_EPOCH)
    moved_ctrl = []
    for _ in range(k):
        snap = params_snapshot(model)
        step(state_ctrl, images, labels, seed_gen)
        moved_ctrl.append(not unchanged(model, snap))
    del state_ctrl, snap
    stats = running_stats(model)
    model.eval()
    with torch.no_grad():
        model(*dual_view_train_batch(images, torch.Generator(device=dev).manual_seed(3), aug),
              labels)
    stats_ctrl = all(not torch.equal(a, b) for a, b in zip(stats, running_stats(model)))
    log(f"  controls: an update every micro-step moved the parameters {moved_ctrl}; an eval "
        f"forward moved the running statistics: {stats_ctrl}")
    if accumulation_pattern_ok(moved_ctrl, k):
        fail("7a: the accumulation check passes its control (an update every micro-step)")
    if stats_ctrl:
        fail("7a: the running-statistics check passes its control (an eval forward)")

    # serving on the running statistics
    infer = make_infer_fn(model, aug)
    reset_launches()
    logits = infer(images)
    torch.cuda.synchronize()
    launches_srv = read_launches()
    if launches_srv != zero_launches(window_attention_fwd=24, subspace_isqrt_fwd=1):
        fail(f"7a serving: launches {launches_srv}")
    if tuple(logits.shape) != (BATCH, 80) or not torch.isfinite(logits).all():
        fail(f"7a serving: logits {tuple(logits.shape)} or non-finite")
    with plain_kernels():
        ref = infer(images)
    stats = running_stats(model)
    for m in batch_norms(model):
        m.train()  # the control: batch statistics in place of the running ones
    ctrl = infer(images)
    torch.cuda.synchronize()
    with torch.no_grad():
        for m, (mean, var) in zip(batch_norms(model), zip(stats[::2], stats[1::2])):
            m.eval()
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)
    scale = max(1.0, ref.float().abs().max().item())
    err = (logits.float() - ref.float()).abs().max().item()
    err_ctrl = (ctrl.float() - ref.float()).abs().max().item()
    tol = TOL_LOGITS_REL[torch.bfloat16]
    log(f"  bf16 logits (batch {BATCH}) kernel vs plain: {err / scale:.4e} of max |logit| "
        f"{scale:.4e}; control (train-mode BatchNorm) {err_ctrl / scale:.4e}; tol {tol}")
    if err > tol * scale:
        fail("7a serving logits disagree with the plain path")
    if err_ctrl <= tol * scale:
        fail("7a serving check passes its control (train-mode BatchNorm)")
    srv_ms, srv_loops = timed_steps(lambda: infer(images), 5)
    log(f"  serving images/s {BATCH / srv_ms * 1e3:.1f} (ms a batch: "
        f"{', '.join(f'{x:.1f}' for x in srv_loops)}), on {card}")
    del model, state, step, infer, logits, ref, ctrl
    torch.cuda.empty_cache()

    # fp32 at batch 4: one update's gradients, kernels vs plain
    f32_cfg = json.loads(json.dumps(cfg))
    f32_cfg["model"]["bf16"] = False
    f32_cfg["model"]["moment"]["bf16_params"] = False
    model32 = create_model(f32_cfg, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model32, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        anchor, positive = dual_view_train_batch(images[:4], torch.Generator(device=dev)
                                                 .manual_seed(2), aug)
    grad_err32 = check_gradients(model32, anchor, positive, labels[:4], torch.float32,
                                 "fp32 batch 4", OPTIONS_BN)
    del model32
    torch.cuda.empty_cache()
    return {"launches": launches, "serve_launches": launches_srv, "losses": losses,
            "step_ms": step_ms, "images_per_s": BATCH / step_ms * 1e3, "peak_gib": peak,
            "serve_images_per_s": BATCH / srv_ms * 1e3, "grad_err_bf16": grad_err,
            "grad_err_f32": grad_err32}


def other_options(card: str) -> dict:
    """Phase 7c: each other option on the flagship, one serving forward and
    one train step at batch 64 (the second timed), logits against the plain
    path at batch 8; the first option's check also rejects the bias omitted."""
    dev = torch.device("cuda")
    out = {}
    for i, (label, change) in enumerate(OTHER_OPTIONS):
        cfg = json.loads(json.dumps(FLAGSHIP))
        for section, values in change.items():
            if isinstance(values, dict):
                cfg["model"][section].update(values)
            else:
                cfg["model"][section] = values
        gpf_runs = int(change.get("gpf", {}).get("adaptive_type") in (None, "global"))
        # the simplified head runs its own iteration, not the subspace kernel
        si_runs = int(change.get("moment", {}).get("variant") != "simplified")
        g = torch.Generator(device=dev).manual_seed(0)
        aug, images = family_inputs({"config": cfg}, g)
        labels = torch.randint(0, 80, (BATCH,), generator=g, device=dev)
        torch.cuda.reset_peak_memory_stats()
        model = create_model(cfg, num_classes=80, device="cuda", seed=0)
        redraw_bias_tables(model, g)
        infer = make_infer_fn(model, aug)
        infer(images)
        reset_launches()
        logits = infer(images)
        torch.cuda.synchronize()
        launches_srv = read_launches()
        if launches_srv != zero_launches(window_attention_fwd=24, gpf_fwd=gpf_runs,
                                         subspace_isqrt_fwd=si_runs):
            fail(f"7c {label}: serving launches {launches_srv}")
        if tuple(logits.shape) != (BATCH, 80) or not torch.isfinite(logits).all():
            fail(f"7c {label}: logits {tuple(logits.shape)} or non-finite")
        srv_ms, _ = timed_steps(lambda: infer(images), 2)
        sub = images[:8]
        out8 = infer(sub)
        with plain_kernels():
            ref = infer(sub)
        torch.cuda.synchronize()
        scale = max(1.0, ref.float().abs().max().item())
        err = (out8.float() - ref.float()).abs().max().item()
        tol = TOL_LOGITS_REL[torch.bfloat16]
        msg = f"{err / scale:.4e} of max |logit| {scale:.4e}; tol {tol}"
        if err > tol * scale:
            fail(f"7c {label}: bf16 logits disagree with the plain path ({msg})")
        if i == 0:
            with bias_omitted(model):
                ctrl = infer(sub)
            err_ctrl = (ctrl.float() - ref.float()).abs().max().item()
            msg += f"; control (kernel without bias) {err_ctrl / scale:.4e}"
            if err_ctrl <= tol * scale:
                fail("7c: the logits check passes its control (bias omitted)")
        state = create_train_state(model, cfg, TRAIN_STEPS_PER_EPOCH)
        step = make_train_step(model, aug)
        seed_gen = torch.Generator(device=dev).manual_seed(1)
        reset_launches()
        loss = step(state, images, labels, seed_gen)
        torch.cuda.synchronize()
        launches = read_launches()
        want = zero_launches(window_attention_fwd=24, window_attention_bwd=24,
                             gpf_fwd=gpf_runs, gpf_bwd=gpf_runs)
        if launches != want:
            fail(f"7c {label}: train launches {launches}, expected {want}")
        t = time.perf_counter()
        loss2 = step(state, images, labels, seed_gen)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        gnorm = state.optimizer.last_grad_norm
        finite = all(torch.isfinite(p).all() for p in model.parameters())
        if not (math.isfinite(loss.item()) and math.isfinite(loss2.item())
                and math.isfinite(gnorm) and finite and state.optimizer.total_notfinite == 0):
            fail(f"7c {label}: loss {loss.item()}, {loss2.item()}, grad norm {gnorm}, "
                 f"parameters finite {finite}, skipped {state.optimizer.total_notfinite}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {label}: launches serving {launches_srv}, a step {launches}; bf16 logits (batch "
            f"8) kernel vs plain {msg}; loss {loss.item():.4f} -> {loss2.item():.4f}, grad norm "
            f"{gnorm:.3f}; serving images/s {BATCH / srv_ms * 1e3:.1f}, step ms {step_ms:.1f} "
            f"({BATCH / step_ms * 1e3:.1f} images/s), peak memory {peak:.2f} GiB, "
            f"{n_params / 1e6:.1f}M parameters, batch {BATCH}, on {card}")
        out[label] = {"serve_launches": launches_srv, "train_launches": launches,
                      "serve_images_per_s": BATCH / srv_ms * 1e3, "step_ms": step_ms,
                      "peak_gib": peak, "logits_err_rel": err / scale}
        del model, infer, state, step, logits, out8, ref
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------
# phase 8: data x model parallelism
# ----------------------------------------------------------------------------

# the mesh runs' stores and checkpoint, inside the checkout and git-ignored;
# removed when the phase ends
MESH_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke_mesh"
MESH_DEVICE = "cuda:0"  # every rank's: the card the ranks share
MESH_TIMEOUT = timedelta(seconds=600)  # every group's: a dead rank fails its peers
MESH_JOIN_S = 600.0
MESH_STEPS = 3
MESH_F32_BATCH = 4
# the checkpoint epoch: 16 classes x 8 images a split, two steps of 64
MESH_CKPT_CLASSES = 16
SHARED_CARD = "ranks sharing one card, gloo through the host: not a scaling number"
MESH_LAUNCHES = zero_launches(window_attention_fwd=24, window_attention_bwd=24, gpf_fwd=1,
                              gpf_bwd=1)


def tensor_checksums(tensors) -> torch.Tensor:
    """Two int64 sums of each tensor's bits, plain and under positional
    weights, on its device (in slices: no copy of a leaf): equal tensors give
    equal sums."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(ints[t.element_size()])
        plain = weighted = torch.zeros((), dtype=torch.int64, device=t.device)
        for lo in range(0, bits.numel(), 1 << 24):
            piece = bits[lo:lo + (1 << 24)].long()
            w = (torch.arange(lo, lo + piece.numel(), device=t.device) * 2654435761) % 1000003
            plain = plain + piece.sum()
            weighted = weighted + (piece * (w + 1)).sum()
        out += [plain, weighted]
    return torch.stack(out)


def equal_over(checks: torch.Tensor, group) -> bool:
    """Whether every rank of ``group`` holds the same checksums."""
    hi, lo = checks.cpu(), checks.cpu().clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return torch.equal(hi, lo)


def optimizer_tensors(opt_state: dict) -> dict:
    return {f"{k}/{n}": t for k in ("master", "m", "v", "v_row", "v_col", "ema", "acc")
            for n, t in sorted(opt_state[k].items())}


def mesh_inputs(dev, batch: int):
    """The phase's global batch (every rank draws all of it) and its fixed
    training views."""
    g = torch.Generator(device=dev).manual_seed(0)
    aug, images = family_inputs(SWIN, g)
    labels = torch.randint(0, 80, (BATCH,), generator=g, device=dev)
    images, labels = images[:batch], labels[:batch]
    with torch.no_grad():
        anchor, positive = dual_view_train_batch(
            images, torch.Generator(device=dev).manual_seed(2), aug)
    return aug, images, labels, anchor, positive


def flagship_model(dev, dtype):
    cfg = json.loads(json.dumps(FLAGSHIP))
    if dtype == torch.float32:
        cfg["model"]["bf16"] = False
        cfg["model"]["moment"]["bf16_params"] = False
    model = create_model(cfg, num_classes=80, device=dev, seed=0)
    redraw_bias_tables(model, torch.Generator(device=dev).manual_seed(5))
    return cfg, model


def mesh_step_gradients(model, mesh, anchor, positive, labels) -> tuple:
    """One forward and backward on this rank's rows (dropout off), the
    gradients summed over 'data' and the sharded ones put back together:
    (loss, {leaf: gradient}, launches, ms of the gradient sum)."""
    b = labels.shape[0] // mesh.data
    lo = mesh.data_index * b
    model.eval()
    model.zero_grad(set_to_none=True)
    reset_launches()
    with kernel_mesh(mesh, b):
        loss = model(anchor[lo:lo + b], positive[lo:lo + b], labels[lo:lo + b])["loss"]
        loss.backward()
    torch.cuda.synchronize()
    launches = read_launches()
    t = time.perf_counter()
    sum_gradients_over_data(model.parameters(), mesh)
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t) * 1e3
    sharded = sharded_params(model)
    grads = {n: unshard(p.grad, sharded[n], mesh) if n in sharded else p.grad
             for n, p in model.named_parameters()}
    return loss.detach().float().item(), grads, launches, reduce_ms


@contextlib.contextmanager
def local_roll_negative(mesh, batch: int):
    """Control: the roll's negative taken on this rank's own rows."""
    b = batch // mesh.data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    roll = _model_module.roll_negative_triplet_loss
    _model_module.roll_negative_triplet_loss = (
        lambda a, p, margin: roll(a[rows], p[rows], margin=margin))
    try:
        yield
    finally:
        _model_module.roll_negative_triplet_loss = roll


@contextlib.contextmanager
def model_dx_sum_dropped():
    """Control: a row-parallel product's input gradient not summed over the
    model group."""
    copy = _layers.copy_to_model
    _layers.copy_to_model = lambda x, mesh: x
    try:
        yield
    finally:
        _layers.copy_to_model = copy


def mesh_gradient_check(mesh, dtype, batch: int, control) -> dict:
    """The mesh's loss and per-leaf gradients against the one-process kernel
    path on the same global batch (rank 0 holds the verdict), with a control
    run through the mesh that must fail."""
    dev = mesh.device
    _, _, labels, anchor, positive = mesh_inputs(dev, batch)
    cfg, model = flagship_model(dev, dtype)
    shard_params(model, mesh)
    loss, grads, launches, reduce_ms = mesh_step_gradients(model, mesh, anchor, positive, labels)
    ctrl_grads = None
    if control is not None:
        name, make = control
        with make():
            ctrl_loss, ctrl_grads, _, _ = mesh_step_gradients(model, mesh, anchor, positive,
                                                              labels)
    del model
    out = {"loss": loss, "launches": launches, "reduce_ms": reduce_ms}
    if mesh.rank == 0:
        grads = {n: g.clone() for n, g in grads.items()}
        _, ref_model = flagship_model(dev, dtype)
        ref_model.eval()
        ref_model.zero_grad(set_to_none=True)
        ref_loss = ref_model(anchor, positive, labels)["loss"]
        ref_loss.backward()
        ref = {n: p.grad for n, p in ref_model.named_parameters()}
        ill = TOL_GRADS_REL_ILL_CONDITIONED
        out.update(ref_loss=ref_loss.float().item(),
                   worst=worst_leaf(grads, ref, dtype, ill), n_leaves=len(ref))
        if ctrl_grads is not None:
            out.update(control=name, control_loss=ctrl_loss,
                       control_worst=worst_leaf(ctrl_grads, ref, dtype, ill))
        del ref_model, ref
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def mesh_train_steps(mesh) -> dict:
    """``MESH_STEPS`` steps of ``make_train_step`` on the mesh (augmentation
    and dropout on) from the same seed on every rank, then every replicated
    leaf compared across all ranks and every sharded one across the ranks
    that hold the same block, by checksum of its bits."""
    dev = mesh.device
    aug, images, labels, _, _ = mesh_inputs(dev, BATCH)
    cfg, model = flagship_model(dev, torch.bfloat16)
    shard_params(model, mesh)
    state = create_train_state(model, cfg, TRAIN_STEPS_PER_EPOCH, device=dev, mesh=mesh)
    step = make_train_step(model, aug, device=dev, mesh=mesh)
    seed_gen = torch.Generator(device=dev).manual_seed(1)
    b = BATCH // mesh.data
    lo = mesh.data_index * b
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, launches = [], [], []
    for _ in range(MESH_STEPS):
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(state, images[lo:lo + b], labels[lo:lo + b], seed_gen)
        losses.append(loss.float().item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(read_launches())
    torch.cuda.synchronize()
    t = time.perf_counter()
    sum_gradients_over_data(model.parameters(), mesh)
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t) * 1e3
    sharded = sharded_params(model)
    params = dict(model.named_parameters())
    rep = tensor_checksums([p for n, p in params.items() if n not in sharded])
    shd = tensor_checksums([p for n, p in params.items() if n in sharded])
    same = {"replicated_over_world": equal_over(rep, dist.group.WORLD),
            "sharded_over_data": equal_over(shd, mesh.data_group),
            "sharded_blocks_differ": not equal_over(shd, mesh.model_group)}
    out = {"step_losses": losses, "step_ms": step_ms, "step_launches": launches,
           "step_reduce_ms": reduce_ms, "same": same, "n_sharded": len(sharded),
           "step_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "notfinite": state.optimizer.total_notfinite}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def mesh_engine_config() -> dict:
    cfg = engine_config("mesh", device_cache=True)
    cfg["dataset"]["num_classes"] = MESH_CKPT_CLASSES
    cfg["training"]["epochs"] = 1
    cfg["experiment"].update({k: str(MESH_DIR / "engine" / k)
                              for k in ("output_dir", "save_dir", "log_dir")},
                             mesh={"data": 2, "model": 1})
    return cfg


def mesh_trainer_checkpoint(mesh) -> dict:
    """One ``Trainer`` epoch on the mesh from the device cache, with
    validation and a checkpoint; the checksums of its gathered parameters
    and optimizer state (rank 0's)."""
    trainer = Trainer(mesh_engine_config(), device=mesh.device, mesh=mesh)
    trainer.setup_data()
    trainer.setup_model()
    res = trainer.train()
    whole = gather_params(trainer.model, mesh)
    opt = optimizer_tensors(trainer.state.optimizer.state_dict())
    out = {"trainer_loss": res["history"]["train_loss"], "trainer_val": res["history"]["val_loss"],
           "trainer_steps": trainer.state.step}
    if mesh.rank == 0:
        out.update(model_sums=tensor_checksums([whole[k] for k in sorted(whole)]).cpu(),
                   model_keys=sorted(whole), opt_sums=tensor_checksums(list(opt.values())).cpu(),
                   opt_keys=list(opt))
    del trainer, whole, opt
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank: int, world: int, data: int, model: int, out_dir: str, tasks: list) -> None:
    """One rank of a mesh of ranks sharing ``cuda:0`` under gloo."""
    pin_fp32_precision()
    torch.cuda.set_device(MESH_DEVICE)
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}", rank=rank,
                            world_size=world, timeout=MESH_TIMEOUT)
    try:
        mesh = create_mesh(data, model, [MESH_DEVICE] * world, timeout=MESH_TIMEOUT)
        res = {"rank": rank}
        t0 = time.time()
        for task in tasks:
            if task == "grads_bf16":
                res["bf16"] = mesh_gradient_check(mesh, torch.bfloat16, BATCH, None)
            elif task == "grads_fp32":
                control = (("roll negative on local rows",
                            lambda: local_roll_negative(mesh, MESH_F32_BATCH))
                           if model == 1 else ("model sum of dx dropped", model_dx_sum_dropped))
                res["fp32"] = mesh_gradient_check(mesh, torch.float32, MESH_F32_BATCH, control)
            elif task == "steps":
                res.update(mesh_train_steps(mesh))
            elif task == "trainer":
                res.update(mesh_trainer_checkpoint(mesh))
        res["seconds"] = time.time() - t0
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_mesh_ranks(data: int, model: int, tasks: list) -> list:
    world = data * model
    out = MESH_DIR / f"{data}x{model}"
    out.mkdir(parents=True)
    ctx = torch.multiprocessing.start_processes(
        mesh_rank, args=(world, data, model, str(out), tasks), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                fail(f"the {data}x{model} mesh's ranks did not finish in {MESH_JOIN_S} s")
    except torch.multiprocessing.ProcessException as exc:
        fail(f"a rank of the {data}x{model} mesh failed: {exc}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def check_mesh_gradients(shape: str, ranks: list) -> dict:
    """Rank 0's verdicts on the bf16 and fp32 checks; every rank's launches."""
    res = {}
    for key, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        r0 = ranks[0][key]
        worst, where, rel = r0["worst"]
        loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        log(f"  {shape} {key} batch {BATCH if dtype == torch.bfloat16 else MESH_F32_BATCH}: "
            f"loss {r0['loss']:.6f} against one process {r0['ref_loss']:.6f} (relative "
            f"{loss_rel:.3e}); gradients, {r0['n_leaves']} leaves, worst err/tol {worst:.4f} "
            f"(relative error {rel:.4e}) at {where}; the gradient sum over 'data' "
            f"{', '.join(f'{r[key]['reduce_ms']:.1f}' for r in ranks)} ms by rank")
        if worst > 1.0:
            fail(f"{shape} {key} mesh gradients disagree with one process")
        if loss_rel > (1e-2 if dtype == torch.bfloat16 else 1e-5):
            fail(f"{shape} {key} mesh loss disagrees with one process")
        if "control" in r0:
            c_worst, c_where, c_rel = r0["control_worst"]
            c_loss_rel = abs(r0["control_loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
            log(f"  {shape} control ({r0['control']}): loss relative {c_loss_rel:.3e}, "
                f"gradients worst err/tol {c_worst:.2f} (relative error {c_rel:.4e}) at "
                f"{c_where}")
            if c_worst <= 1.0:
                fail(f"{shape} mesh gradient check passes its control ({r0['control']})")
        for r in ranks:
            if key == "bf16" and r[key]["launches"] != MESH_LAUNCHES:
                fail(f"{shape} rank {r['rank']}: launches {r[key]['launches']}, expected "
                     f"{MESH_LAUNCHES}")
        res[key] = {"loss_rel": loss_rel, "worst": worst, "rel": rel, "where": where,
                    "reduce_ms": [r[key]["reduce_ms"] for r in ranks]}
    res["launches"] = [r["bf16"]["launches"] for r in ranks]
    return res


def mesh_phase(card: str) -> dict:
    """(a) a 1 x 1 mesh under NCCL in this process against ``make_train_step``;
    (b) meshes of ranks sharing the card under gloo: gradients against one
    process, launches per rank, replicated leaves after three steps; (c) a
    ``Trainer`` epoch on (2, 1) restored on the 1 x 1 mesh."""
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    dev = torch.device(MESH_DEVICE)
    dist.init_process_group("nccl", init_method=f"file://{MESH_DIR / 'store'}", rank=0,
                            world_size=1, timeout=MESH_TIMEOUT)
    try:
        mesh = create_mesh(1, 1, timeout=MESH_TIMEOUT)  # rank 0 takes cuda:0
        log(f"  (a) 1 x 1 mesh under {dist.get_backend()} on {mesh.device}")
        aug, images, labels, _, _ = mesh_inputs(dev, BATCH)
        cfg, model_m = flagship_model(dev, torch.bfloat16)
        _, model_p = flagship_model(dev, torch.bfloat16)
        if shard_params(model_m, mesh):
            fail("a 1 x 1 mesh sharded a leaf")
        state_m = create_train_state(model_m, cfg, TRAIN_STEPS_PER_EPOCH, device=dev, mesh=mesh)
        state_p = create_train_state(model_p, cfg, TRAIN_STEPS_PER_EPOCH, device=dev)
        step_m = make_train_step(model_m, aug, device=dev, mesh=mesh)
        step_p = make_train_step(model_p, aug, device=dev)
        gen_m = torch.Generator(device=dev).manual_seed(1)
        gen_p = torch.Generator(device=dev).manual_seed(1)

        def same_bits() -> bool:
            return all(torch.equal(a, b) for a, b in zip(model_m.parameters(),
                                                        model_p.parameters()))

        for i in range(MESH_STEPS):
            reset_launches()
            loss_m = step_m(state_m, images, labels, gen_m)
            torch.cuda.synchronize()
            launches_1x1 = read_launches()
            loss_p = step_p(state_p, images, labels, gen_p)
            if not torch.equal(loss_m, loss_p) or not same_bits():
                fail(f"(a) step {i}: the 1 x 1 mesh step differs from make_train_step "
                     f"({loss_m.item()} vs {loss_p.item()})")
            if launches_1x1 != MESH_LAUNCHES:
                fail(f"(a) step {i}: launches {launches_1x1}, expected {MESH_LAUNCHES}")
        turns = in_turns({"one": lambda: step_p(state_p, images, labels, gen_p),
                          "mesh": lambda: step_m(state_m, images, labels, gen_m)}, 3)
        if not same_bits():
            fail("(a) the timed steps left the two models apart")
        reduce_ms = time_ms(lambda: sum_gradients_over_data(model_m.parameters(), mesh), 3, 3)
        # a mesh rank draws the dropout masks of the global batch: the
        # backbone's [2 x 64, 56, 56, 128] after the patch embedding, at
        # every data size, against drawing only its rows
        g = torch.Generator(device=dev).manual_seed(3)
        site = (2 * BATCH, 56, 56, 128)
        draw_ms = {d: (time_ms(lambda: torch.rand(site, device=dev, generator=g), 5, 3),
                       time_ms(lambda: torch.rand((site[0] // d,) + site[1:], device=dev,
                                                  generator=g), 5, 3)) for d in (2, 4, 8)}
        log(f"  (a) {MESH_STEPS} steps bit for bit make_train_step's (loss, every parameter); "
            f"launches a step {launches_1x1}; step ms in turns (one, mesh, mesh, one, one, "
            f"mesh; 3 steps each; medians): make_train_step {turns['one'] * 1e3:.1f}, 1 x 1 "
            f"mesh {turns['mesh'] * 1e3:.1f}; the gradient sum over 'data' (NCCL, one rank) "
            f"{reduce_ms:.2f} ms a step, on {card}")
        log(f"  (a) dropout masks of the backbone's {list(site)} drawn whole by a rank against "
            f"its rows alone: {', '.join(f'data {d}: {a:.3f} / {b:.3f} ms' for d, (a, b) in draw_ms.items())}")
        del model_m, model_p, state_m, state_p, step_m, step_p
        gc.collect()
        torch.cuda.empty_cache()

        log(f"  (b) 2 ranks on (2, 1) and 4 on (2, 2) sharing cuda:0 under gloo, global batch "
            f"{BATCH}; (c) a Trainer epoch on (2, 1)")
        t = time.time()
        r21 = run_mesh_ranks(2, 1, ["grads_bf16", "grads_fp32", "trainer"])
        s21 = time.time() - t
        g21 = check_mesh_gradients("(2, 1)", r21)
        # (c): the (2, 1) Trainer's checkpoint restored on the 1 x 1 mesh
        r0 = r21[0]
        ckpt = MESH_DIR / "engine" / "save_dir" / "checkpoint_epoch_0"
        cfg_c = mesh_engine_config()
        model_c = create_model(cfg_c, num_classes=MESH_CKPT_CLASSES, device=dev, seed=0)
        shard_params(model_c, mesh)
        state_c = create_train_state(model_c, cfg_c, 2, device=dev, mesh=mesh)
        t = time.time()
        bundle = restore_checkpoint(str(ckpt), device=dev)
        load_params(model_c, bundle["model"], mesh)
        state_c.optimizer.load_state_dict(bundle["optimizer"])
        restore_s = time.time() - t
        whole = gather_params(model_c, mesh)
        opt = optimizer_tensors(state_c.optimizer.state_dict())
        if sorted(whole) != r0["model_keys"] or list(opt) != r0["opt_keys"]:
            fail("(c) the restored checkpoint holds other leaves")
        model_ok = torch.equal(tensor_checksums([whole[k] for k in sorted(whole)]).cpu(),
                               r0["model_sums"])
        opt_ok = torch.equal(tensor_checksums(list(opt.values())).cpu(), r0["opt_sums"])
        log(f"  (c) Trainer on (2, 1): {r0['trainer_steps']} steps, train loss "
            f"{r0['trainer_loss'][0]:.4f}, val loss {r0['trainer_val'][0]:.4f}; checkpoint "
            f"restored on 1 x 1 in {restore_s:.1f} s: parameters and buffers bit for bit "
            f"{model_ok} ({len(whole)} tensors), optimizer state {opt_ok} ({len(opt)} tensors)")
        if not (model_ok and opt_ok):
            fail("(c) the checkpoint restored on 1 x 1 is not the mesh's gathered state")
        if r0["trainer_steps"] != 2 or not all(map(math.isfinite, r0["trainer_loss"])):
            fail(f"(c) the Trainer epoch ran {r0['trainer_steps']} steps, loss "
                 f"{r0['trainer_loss']}")
        del model_c, state_c, bundle, whole, opt
        torch.cuda.empty_cache()

        t = time.time()
        r22 = run_mesh_ranks(2, 2, ["grads_bf16", "grads_fp32", "steps"])
        s22 = time.time() - t
        g22 = check_mesh_gradients("(2, 2)", r22)
        for r in r22:
            if not all(r["same"].values()):
                fail(f"(2, 2) rank {r['rank']} after {MESH_STEPS} steps: {r['same']}")
            if any(lc != MESH_LAUNCHES for lc in r["step_launches"]):
                fail(f"(2, 2) rank {r['rank']}: step launches {r['step_launches']}")
            if r["notfinite"] or not all(map(math.isfinite, r["step_losses"])):
                fail(f"(2, 2) rank {r['rank']}: losses {r['step_losses']}")
        log(f"  (2, 2) after {MESH_STEPS} steps: every replicated leaf bit for bit on the 4 "
            f"ranks, every sharded leaf ({r22[0]['n_sharded']}) on its 2; losses "
            f"{', '.join(f'{x:.4f}' for x in r22[0]['step_losses'])}")
        for label, ranks, secs in (("(2, 1)", r21, s21), ("(2, 2)", r22, s22)):
            for r in ranks:
                extra = ""
                if "step_ms" in r:
                    extra = (f", step ms {', '.join(f'{x:.1f}' for x in r['step_ms'])} (the "
                             f"gradient sum over 'data' {r['step_reduce_ms']:.1f} ms), step peak "
                             f"{r['step_peak_gib']:.2f} GiB")
                log(f"  {label} rank {r['rank']}: peak {r['peak_gib']:.2f} GiB{extra}, "
                    f"{r['seconds']:.1f} s of tasks")
            log(f"  {label}: {secs:.1f} s with start-up; {SHARED_CARD}; on {card}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    return {"1x1": {"launches": launches_1x1, "turns_ms": {k: v * 1e3 for k, v in turns.items()},
                    "reduce_ms": reduce_ms, "dropout_draw_ms": draw_ms},
            "2x1": g21, "2x2": {**g22, "step_ms": [r["step_ms"] for r in r22],
                                "step_reduce_ms": [r["step_reduce_ms"] for r in r22],
                                "step_launches": [r["step_launches"][-1] for r in r22]},
            "peak_gib": {"2x1": [r["peak_gib"] for r in r21], "2x2": [r["peak_gib"] for r in r22]},
            "restore_s": restore_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", help="write a torch.profiler table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.time()

    def phase(msg: str) -> None:
        log(f"{msg} (at {time.time() - t_start:.1f} s)")

    pin_fp32_precision()  # the plain versions' fp32 products in true fp32, as the entry points do
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase("[1] building kernels")
    t0 = time.time()
    paths = _build.build()
    log(f"  built {len(paths)} kernels in {time.time() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:  # ptxas: registers, spills, wgmma serialized (C7511) or fenced
            if any(k in line for k in ("registers", "spill", "wgmma", "GMMA")):
                log(f"  {name}: {line.strip()}")

    phase("[2] every kernel at its main paths' calls against its plain version, bf16")
    mains = main_path_kernels()

    phase("[3] serving, Swin-Base/224 flagship, batch 64")
    srv = serve(card, args.profile, SWIN)
    torch.cuda.empty_cache()

    phase(f"[4] training, Swin-Base/224 flagship, batch {BATCH}")
    trn = train(card, args.profile, SWIN)
    torch.cuda.empty_cache()

    phase("[3f] serving, Swin-Base/224 flagship under backbone_attn_kernel fused_half, batch 64")
    srv_fh = serve(card, args.profile, SWIN_FH)
    torch.cuda.empty_cache()

    phase(f"[4f] training, Swin-Base/224 flagship under backbone_attn_kernel fused_half, batch "
        f"{BATCH}")
    trn_fh = train(card, args.profile, SWIN_FH)
    torch.cuda.empty_cache()

    phase("[5] serving, ViT-Base/224 with the flagship heads, batch 64")
    srv_vit = serve(card, args.profile, VIT)
    torch.cuda.empty_cache()

    phase(f"[5b] training, ViT-Base/224 with the flagship heads, batch {BATCH}")
    trn_vit = train(card, args.profile, VIT)
    torch.cuda.empty_cache()

    phase("[5c] serving, ViT-Base/448 with the flagship heads, batch 64 (kernel path vs plain "
        "path at batch 8 in bf16 and 2 in fp32: the plain attention's probabilities are "
        "[B, 12, 785, 785] fp32)")
    srv_448 = serve(card, args.profile, VIT448)
    torch.cuda.empty_cache()

    phase(f"[5d] training, ViT-Base/448 with the flagship heads, batch {BATCH} (gradients vs the "
        "plain path at batch 8 in bf16 and 2 in fp32)")
    trn_448 = train(card, args.profile, VIT448)
    torch.cuda.empty_cache()

    phase("[5e] serving, ViT-Large/512 with the flagship heads, batch 64 (kernel path vs plain "
          "path at batch 8 in bf16 and 2 in fp32)")
    srv_vitl = serve(card, args.profile, VITL512)
    torch.cuda.empty_cache()

    phase(f"[5f] training, ViT-Large/512 with the flagship heads under block checkpointing, "
          f"batch {BATCH} (gradients vs the plain path at batch 8 in bf16 and 2 in fp32)")
    trn_vitl = train(card, args.profile, VITL512)
    torch.cuda.empty_cache()

    phase("[5g] serving, Swin-Large/1280 with the flagship heads, batch 64 (kernel path vs "
          "plain path at batch 8 in bf16 and 2 in fp32)")
    srv_swinl = serve(card, args.profile, SWINL1280)
    torch.cuda.empty_cache()

    phase("[5h] serving, EVA-02-Large/14 at 448 with the flagship heads, batch 64 (kernel path "
          "vs plain path at batch 8 in bf16 and 2 in fp32)")
    srv_eva = serve(card, args.profile, EVA448)
    torch.cuda.empty_cache()

    phase(f"[6] data pipeline, trainer, evaluator and checkpoints, Swin-Base/224 flagship, batch "
          f"{BATCH}, synthetic 80 x 8 images a split")
    eng = engine(card)
    # phase 6's trainers leave ~4.1 GiB on the card in reference cycles, which
    # would count in phase 7's peaks until Python's collector ran
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[7a] training and serving, Swin-Base/224 flagship with adaptive GPF (attention), "
          f"BatchNorm heads, the adaptive classifier and accumulation 2, batch {BATCH}")
    opt_bn = options_batchnorm(card)
    torch.cuda.empty_cache()

    phase(f"[7b] serving and training, ViT-Large/16 at 448 with the multi-scale classifier, "
          f"batch {BATCH} (kernel path vs plain path at batch 8 in bf16 and 2 in fp32)")
    srv_vitl448 = serve(card, args.profile, VITL448_MS)
    torch.cuda.empty_cache()
    trn_vitl448 = train(card, args.profile, VITL448_MS)
    torch.cuda.empty_cache()

    phase(f"[7c] the other options at Swin-Base/224, one forward and one step each, batch "
          f"{BATCH}")
    opt_other = other_options(card)
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"[8] data x model parallelism, Swin-Base/224 flagship, global batch {BATCH}: a 1 x 1 "
          f"mesh under NCCL, ranks sharing the card under gloo")
    par = mesh_phase(card)

    for label, s_res, t_res in (("Swin-Base/224", srv, trn),
                                ("Swin-Base/224 fused_half", srv_fh, trn_fh),
                                ("ViT-Base/224", srv_vit, trn_vit),
                                ("ViT-Base/448", srv_448, trn_448),
                                ("ViT-Large/512", srv_vitl, trn_vitl),
                                ("Swin-Large/1280", srv_swinl, None),
                                ("EVA-02-Large/448", srv_eva, None),
                                ("ViT-Large/448 multi-scale", srv_vitl448, trn_vitl448)):
        train_msg = ("not run" if t_res is None else
                     f"{t_res['images_per_s']:.1f} images/s ({t_res['step_ms']:.1f} ms/step, "
                     f"peak {t_res['peak_gib']:.2f} GiB)")
        log(f"  {label}: serving {s_res['images_per_s']:.1f} images/s (peak "
            f"{s_res['peak_gib']:.2f} GiB), training {train_msg}")
    ips = eng["images_per_s"]
    log(f"  Swin-Base/224 engine (phase 6): train_epoch images/s device cache "
        f"{', '.join(f'{x:.1f}' for x in ips['device_cache_epochs'])}, host loader "
        f"{', '.join(f'{x:.1f}' for x in ips['host_loader_epochs'])}, make_train_step "
        f"{ips['make_train_step']:.1f}; evaluator {ips['evaluator']:.1f} against make_infer_fn "
        f"{ips['make_infer_fn']:.1f}")
    log(f"  Swin-Base/224 adaptive + BatchNorm + accumulation 2 (phase 7a): micro-step "
        f"{opt_bn['step_ms']:.1f} ms ({opt_bn['images_per_s']:.1f} images/s, peak "
        f"{opt_bn['peak_gib']:.2f} GiB), serving {opt_bn['serve_images_per_s']:.1f} images/s")
    for label, res in opt_other.items():
        log(f"  Swin-Base/224 {label} (phase 7c): serving {res['serve_images_per_s']:.1f} "
            f"images/s, step {res['step_ms']:.1f} ms, peak {res['peak_gib']:.2f} GiB")
    log(f"  data x model parallelism (phase 8): 1 x 1 mesh step {par['1x1']['turns_ms']['mesh']:.1f}"
        f" ms against make_train_step {par['1x1']['turns_ms']['one']:.1f}; (2, 2) step ms by rank "
        f"{[[round(x, 1) for x in r] for r in par['2x2']['step_ms']]} ({SHARED_CARD})")
    # every path of phases 3-8, each driven with the counts at 0 just before
    # and read just after: {path: {wrapper: launches}}
    paths = {"3": srv["launches"], "4": trn["launches"], "3f": srv_fh["launches"],
             "4f": trn_fh["launches"], "5": srv_vit["launches"], "5b": trn_vit["launches"],
             "5c": srv_448["launches"], "5d": trn_448["launches"], "5e": srv_vitl["launches"],
             "5f": trn_vitl["launches"], "5g": srv_swinl["launches"], "5h": srv_eva["launches"],
             "6_step": eng["step_launches"], "6_eval": eng["eval_launches"],
             "7a_step": opt_bn["launches"], "7a_serve": opt_bn["serve_launches"],
             "7b_serve": srv_vitl448["launches"], "7b_step": trn_vitl448["launches"],
             **{f"7c_{label}_{what}": res[f"{what}_launches"] for label, res in opt_other.items()
                for what in ("serve", "train")},
             "8_1x1": par["1x1"]["launches"]}
    kernels = []
    for name in COUNTERS:
        launched = {path: counts[name] for path, counts in paths.items() if counts[name]}
        if not launched:
            fail(f"kernel {name} was launched no time on the paths of phases 3-8")
        kernels.append({"name": name, "calls": mains[name], "launches": launched})
    log(f"  total {time.time() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
