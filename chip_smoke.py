#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py                 # what the check runs: one card
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table

Phases (any failed check exits non-zero; no phase catches and continues):

1. Setup: card name and power limit, kernel build from ``csrc/`` (seconds),
   ptxas's register, spill and wgmma notes (a C7511 note says a wgmma was
   serialized), and the SASS of the Hopper kernels (the bf16 attention
   forward and backward 3, 6, 3b, 6b, the GPF forward 2 and backward 2b, the
   bf16 Newton-Schulz 5′ and 5″, the window-attention forward 1 and
   backward 1b and the fused attention half's forward 4 and backward 4b) read
   for their wgmma (HGMMA) instructions, which must be there.
2. Kernels against their plain PyTorch versions on the card.  Forward, at the
   serving paths' shapes for batch 64: window attention at the four Swin-Base
   stage geometries (shifted and unshifted, bf16 and fp32), packed-layout
   attention at the ViT-Base and ViT-Tiny calls ([64, 1, 197, 3C], no bias, no
   mask) and at a Swin packed shape with bias and mask, and fused GPF at
   [64, 49, 1024], [64, 196, 768] and [64, 784, 768] (dot and cosine, bf16 and
   fp32), with
   errors, kernel / plain / library times from CUDA events and the
   bytes-or-operations bound (for GPF the least work, the upper triangle of
   its Grams, beside the full Grams' figure).  Backward, at the training paths' shapes: both
   attentions for batch 128 (two views of 64) with a random output cotangent
   (window attention beside SDPA's backward with the bias gradient, the same
   function, and without it),
   and fused GPF at all three shapes with two distinct token sets (and once with one
   tensor twice); for the bf16 training call it prints the times of its two
   launches apart (torch.profiler: the w kernel, the dX kernel).  The attention backward kernels start from the forward
   kernels' out and log-sum-exp (the packed forward is also held to the plain
   log-sum-exp) and print TFLOP/s on their 14 T^2 d flops beside SDPA's
   backward; the attention forwards print TFLOP/s on 4 T^2 d (kernel 6) or
   GB/s on the bytes they must move (kernel 3) beside SDPA's, and their
   registers and blocks an SM, and two runs of each must agree bit for bit.
   Each check is run on a control too (bias or mask dropped,
   padded keys left unmasked, off-diagonal GPF entries zeroed; bias gradient
   dropped, dK zeroed, coefficient gradient zeroed, half of dX dropped), which
   it must reject; two runs of the packed backward must agree bit for bit.
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
   Phase 2 / 2b hold the new kernels at the 448 path's shapes: q-tiled
   attention at [64, 785, 2304] and its backward at batch 128 (controls:
   padded keys unmasked, first 64 keys only, dK zeroed; two backward runs
   equal bit for bit), and the Newton-Schulz iteration at [64, 768, 768] with
   M built as the head builds it and at [64, 192, 192] (control: four
   iterations instead of five), bf16 and fp32.
   Phase 2 / 2b also hold the fused attention half (LayerNorm, qkv, window
   attention, proj and residual in one kernel) at Swin-Base's stages 0 and 1,
   [64, 56, 56, 128] with 4 heads and [64, 28, 28, 256] with 8, unshifted and
   shifted, bf16 and fp32 (controls: bias omitted, residual dropped), and its
   backward at batch 128: dx per element, each parameter gradient within a
   fraction of its largest entry, two runs equal bit for bit (controls: one
   token chunk's dwqkv partial dropped, dbias dropped), the forward held again
   at batch 128, the training forward's own launches (same tolerance and
   controls).  Beside kernel and
   plain times they time PyTorch's own calls for the block (layer_norm,
   linear, SDPA, linear, add; autograd of them) and the port's default route
   (LayerNorm, Dense, kernel 1 / 1b, Dense, add); the backward's bf16 call
   also prints its time split among its launches (torch.profiler).
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
   Phase 2 / 2b hold their kernels at these paths' shapes: kernels 5′ at
   [64, 1024, 1024] and 5″ at [64, 1536, 1536] (M as the head builds it, bf16
   and fp32, two runs bit for bit, one step bit for bit with the plain
   version; control: four iterations; the other grouping printed; TFLOP/s
   beside the cuBLAS iteration's), the
   window attention at Swin-Large stage 0's padded canvas [8, 322, 322, 576]
   with the pad sentinel in the mask (control: the sentinel removed) and
   timed at batch 64 on every Swin-Large/1280 stage, summed over a forward's
   24 launches beside their bytes bound, q-tiled
   attention at [64, 1025, 3072] with 16 heads and its backward at batch 128
   (bf16, the plain version on the first 16 images), GPF at [64, 1024, 1024] and
   [64, 1600, 1536] and its backward at [64, 1024, 1024] and [64, 1600,
   1536] (the plain version at the same batch), and the iSQRT's
   backward (autograd over the plain fp32 iteration) at [64, 1024, 1024].
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
7. A JSON line of the thirteen kernels, then the contract's last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

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
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as _wa
from ego_moment_cle_vit_tpu_torch.models.swin import (
    SwinBlock,
    _attn_mask,
    _relative_position_index,
)
from ego_moment_cle_vit_tpu_torch.ops.graph import (
    gpf_fuse,
    normalize_graph,
    token_similarity_graph,
)
from ego_moment_cle_vit_tpu_torch.ops.moments import graph_weighted_mean
from ego_moment_cle_vit_tpu_torch.train import Evaluator, Trainer
from ego_moment_cle_vit_tpu_torch.train import trainer as _trainer_module
from ego_moment_cle_vit_tpu_torch.utils.device import pin_fp32_precision
from kernel_turns import (
    attention_half_unfused,
    attn_half_inputs,
    launch_split,
    window_sdpa_backward,
)

BATCH = 64
TRAIN_VIEWS = 2 * BATCH  # the dual-view step runs both views as one backbone batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; fp32 non-TC
# Swin-Base/224 stages: (Hp = Wp, C, heads, blocks); odd blocks shift when Hp > ws
STAGES = ((56, 128, 4, 2), (28, 256, 8, 2), (14, 512, 16, 18), (7, 1024, 32, 2))
WS = 7
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
VIT448_T = 785  # 28 x 28 patches + CLS: past the packed kernel, on kernel 6's path
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
# Swin-Large at a 1280 input (the flagship's 256 / 224 resize ratio): stage
# canvases 320, 160, 80, 40 padded to 322, 161, 84, 42 for windows of 7, heads
# of 32; the last stage's 1600 tokens >= D = 1536 take the dense route through
# kernel 5″
SWINL1280_FLAGSHIP = json.loads(json.dumps(FLAGSHIP))
SWINL1280_FLAGSHIP["model"]["backbone_name"] = "swin_large_patch4_window7_224"
SWINL1280_FLAGSHIP["data"] = {"input_size": 1280, "resize_size": 1463}
SWINL_N, SWINL_C = 1600, 1536
SWINL_STAGE0 = (320, 322, 192, 6)  # canvas, padded canvas, C, heads
# every Swin-Large/1280 stage: canvas, padded canvas, C, heads, blocks
SWINL_STAGES = (SWINL_STAGE0 + (2,), (160, 161, 384, 12, 2), (80, 84, 768, 24, 18),
                (40, 42, 1536, 48, 2))
# images a plain window-attention call takes at Swin-Large/1280 stage 0: its
# fp32 probabilities [8, 2116, 6, 49, 49] are 0.98 GB
PLAIN_SLICE = 8
TRAIN_STEPS_PER_EPOCH = 100
# tolerances, kernel vs plain on the card, per element.  Window attention:
# |err| <= atol + rtol |ref|; fp32 differs by sum order only, bf16 by P rounded
# to bf16 before P v (as on the TPU) plus at most one bf16 ulp (2^-7 |y|) of
# the output's rounding.  GPF: |err| <= tol x gpf_error_scale, which holds
# each entry at its own size (see kernels/gpf.py).
TOL_WA = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0**-7)}
TOL_GPF = 2e-4
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
# backward kernels vs plain on the card.  Window attention: dqkv per element
# |err| <= atol + rtol |ref| (both sides round P and ds to the input type, so
# they differ by sum order and, in bf16, by a rounding that lands on the other
# side: two ulps of the output); dbias, a sum over 128 x nW windows, within
# btol of its own largest entry.  GPF: token gradients within tol of their
# row's largest entry, dc within 1e-3 of its largest entry; the cotangent is
# zeroed where the pre-activation is within 1e-4 of its error scale of zero,
# since on the clamp's kink the two sides may round to different branches.
TOL_WA_BWD = {torch.float32: (1e-4, 1e-4, 1e-3), torch.bfloat16: (2e-2, 2.0**-6, 2e-2)}
TOL_GPF_BWD = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
TOL_GPF_DC = 1e-3
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
# tightly on shared inputs in phase 2; here it must be finite and of the
# reference's order of magnitude.
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
COEFF_WITNESS_SEEDS = (2, 3, 4)  # view seeds of the 448 witness; 2 is the check's own
# q-tiled attention, kernel vs plain per element, |err| <= atol + rtol |ref|.
# Forward: fp32 by sum order; bf16 by one ulp of the output's rounding (2^-7
# |y|) over a pre-rounding difference far under atol (the kernel rounds the
# unnormalized probabilities of its online softmax, the plain version the
# normalized ones).  atol sits well under a 785-token output's typical size
# (~0.06 for unit-variance v), so that the padded-keys control, which moves
# each output by ~6 %, fails.  Backward: the same, with two ulps (ds rounded
# on both sides from slightly different fp32 values, then the output).
TOL_FA = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-3, 2.0**-7)}
TOL_FA_BWD = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (4e-3, 2.0**-6)}
# Newton-Schulz, kernel vs plain per element: |err| <= rtol |ref| + atol x
# max |ref|.  fp32: sum order over 14 chained products; bf16: one ulp of the
# output's rounding over the same fp32 difference.
TOL_NS = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0**-7, 1e-4)}
# Kernels 5′ and 5″ against plain versions that round where they round and
# normalize by the same trace, M in either type: |err| <= 2^-7 |ref| + 5e-4
# max |ref|.  Both sides round Y, T1, T2 (P) to bf16 from fp32 sums taken in
# other orders, so an element now and then lands one bf16 ulp apart and the
# later steps carry that at the size of the entries.  Started from TOL_NS[bf16]
# (atol 1e-4): on the head's M (rank <= 16, from a rank-16 graph; an H100)
# sound runs read 0.51-0.88 of that, cuBLAS at the same rounding points the
# same, four iterations 42x; atol 5e-4 sits between, ~5x from each.  The other
# variant's grouping (5′ held against 5″'s plain version) read 1.1-1.4 of
# the atol-1e-4 bar, inside this one: that control is printed, not enforced.
TOL_NS_BF16 = (2.0**-7, 5e-4)
# fused attention half, kernel vs plain, |err| <= atol + rtol |ref| per
# element.  fp32: sum order.  bf16: both sides round xn, qkv, P and om, and an
# fp32 sum that lands on the other side of a rounding moves one bf16 ulp
# through the proj product, then y's own rounding adds one ulp (2^-8 |y|).
# Backward: dx likewise; each parameter gradient within gtol of its own
# largest entry (sums over 10^5 tokens of rounded products).
TOL_AH = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2.0**-6)}
TOL_AH_BWD = {torch.float32: (1e-4, 1e-4, 1e-3), torch.bfloat16: (3e-2, 2.0**-6, 2e-2)}
# the fused path against the default path on the same weights: bf16 logits
# within 2e-2 relative L2 (the JAX package's bar, tests/test_attn_half.py);
# fp32 logits within 1e-3 of max |logit|
TOL_FUSED_VS_DEFAULT = {torch.bfloat16: 2e-2, torch.float32: 1e-3}

WA_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:361"
GPF_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/gpf.py:41"
WA_BWD_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:389"
GPF_BWD_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/gpf.py:126"
PA_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:133"
PA_BWD_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:155"
FA_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/flash_attention.py:75"
FA_BWD_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/flash_attention.py:94"
NS_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/newton_schulz.py:43"
NS_BF16_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/newton_schulz.py:99"
NS_BF16S_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/newton_schulz.py:157"
AH_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/attn_half.py:73"
AH_BWD_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/attn_half.py:128"
WA_KERNEL = _wa.window_attention_fwd
GPF_KERNEL = _gpf.gpf_fwd
WA_BWD_KERNEL = _wa.window_attention_bwd
GPF_BWD_KERNEL = _gpf.gpf_bwd
PA_KERNEL = _pa.packed_attention_fwd
PA_BWD_KERNEL = _pa.packed_attention_bwd
FA_KERNEL = _fa.flash_attention_tiled_fwd
FA_BWD_KERNEL = _fa.flash_attention_tiled_bwd
NS_KERNEL = _ns.newton_schulz_isqrt_fp32_fwd
NS_BF16_KERNEL = _ns.newton_schulz_isqrt_bf16_fwd
NS_BF16S_KERNEL = _ns.newton_schulz_isqrt_bf16_streamed_fwd
# kernel, its plain version, the other grouping's plain version
NS_BF16_VARIANTS = {
    "bf16": (NS_BF16_KERNEL, _ns.newton_schulz_isqrt_bf16_plain,
             _ns.newton_schulz_isqrt_bf16_streamed_plain),
    "bf16_streamed": (NS_BF16S_KERNEL, _ns.newton_schulz_isqrt_bf16_streamed_plain,
                      _ns.newton_schulz_isqrt_bf16_plain),
}
AH_KERNEL = _ah.attn_half_fwd
AH_BWD_KERNEL = _ah.attn_half_bwd
KERNELS = {"window_attention_fwd": WA_KERNEL, "window_attention_bwd": WA_BWD_KERNEL,
           "gpf_fwd": GPF_KERNEL, "gpf_bwd": GPF_BWD_KERNEL,
           "packed_attention_fwd": PA_KERNEL, "packed_attention_bwd": PA_BWD_KERNEL,
           "flash_attention_tiled_fwd": FA_KERNEL, "flash_attention_tiled_bwd": FA_BWD_KERNEL,
           "newton_schulz_isqrt_fp32_fwd": NS_KERNEL,
           "newton_schulz_isqrt_bf16_fwd": NS_BF16_KERNEL,
           "newton_schulz_isqrt_bf16_streamed_fwd": NS_BF16S_KERNEL,
           "attn_half_fwd": AH_KERNEL, "attn_half_bwd": AH_BWD_KERNEL}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20, samples: int = 5) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back calls."""
    for _ in range(3):
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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper the model calls for its plain version.  The
    Newton–Schulz dispatch then reaches the plain version of the variant its
    width picks, so the plain path rounds where the kernel path does."""
    saved = (_wa.window_attention_fwd, _wa.window_attention_bwd, _gpf.gpf_fwd, _gpf.gpf_bwd,
             _pa.packed_attention_fwd, _pa.packed_attention_bwd, _fa.flash_attention_tiled_fwd,
             _fa.flash_attention_tiled_bwd, _ns.newton_schulz_isqrt_fp32_fwd,
             _ns.newton_schulz_isqrt_bf16_fwd, _ns.newton_schulz_isqrt_bf16_streamed_fwd,
             _ah.attn_half_fwd, _ah.attn_half_bwd)
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
    try:
        yield
    finally:
        (_wa.window_attention_fwd, _wa.window_attention_bwd, _gpf.gpf_fwd, _gpf.gpf_bwd,
         _pa.packed_attention_fwd, _pa.packed_attention_bwd, _fa.flash_attention_tiled_fwd,
         _fa.flash_attention_tiled_bwd, _ns.newton_schulz_isqrt_fp32_fwd,
         _ns.newton_schulz_isqrt_bf16_fwd, _ns.newton_schulz_isqrt_bf16_streamed_fwd,
         _ah.attn_half_fwd, _ah.attn_half_bwd) = saved


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


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0


def read_launches() -> dict:
    return {name: kernel.launches for name, kernel in KERNELS.items()}


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


def wa_excess(out: torch.Tensor, ref: torch.Tensor, dtype) -> float:
    """Largest |out - ref| / (atol + rtol |ref|); the check passes at <= 1."""
    atol, rtol = TOL_WA[dtype]
    ref = ref.float()
    return ((out.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def gpf_excess(out: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    """Largest |out - ref| / (TOL_GPF x scale); the check passes at <= 1."""
    return ((out - ref).abs() / (TOL_GPF * scale)).max().item()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------------


def check_window_attention(g: torch.Generator) -> dict:
    dev = torch.device("cuda")
    nt = WS * WS
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=dev)
    per_forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    max_err = 0.0
    min_control = math.inf
    bound_kinds = {"bytes": 0.0, "operations": 0.0}  # share of the summed bound by its kind
    for hp, c, heads, blocks in STAGES:
        table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=dev) * BIAS_TABLE_STD
        bias = table[idx].reshape(nt, nt, heads).permute(2, 0, 1).contiguous()
        nw = (hp // WS) ** 2
        shifts = (False, True) if hp > WS else (False,)
        for shifted in shifts:
            mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, WS, WS // 2), device=dev)
                    if shifted else None)
            # Swin shifts odd blocks, and never when one window covers the map
            n_blocks = blocks if hp == WS else (blocks // 2 if shifted else blocks - blocks // 2)
            for dtype in (torch.bfloat16, torch.float32):
                qkv = torch.randn(BATCH, hp, hp, 3 * c, generator=g, device=dev).to(dtype)
                scale = (c // heads) ** -0.5
                args = (qkv, bias, mask, heads, WS, scale)
                out = WA_KERNEL(*args)
                ref = _wa.window_attention_plain(*args)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                excess = wa_excess(out, ref, dtype)
                what = f"window attention {hp}x{hp} C={c} shift={shifted} {dtype}"
                if not math.isfinite(excess) or excess > 1.0:
                    fail(f"{what}: error {excess:.3f}x its tolerance {TOL_WA[dtype]} "
                         f"(max abs err {err})")
                max_err = max(max_err, err)
                # controls: the plain version without its bias, or without its
                # mask, must fail the same check, or the check has no power
                controls = [_wa.window_attention_plain(qkv, torch.zeros_like(bias), mask,
                                                       heads, WS, scale)]
                if mask is not None:
                    controls.append(_wa.window_attention_plain(qkv, bias, None, heads, WS,
                                                               scale))
                for ctrl in controls:
                    ctrl_excess = wa_excess(ctrl, ref, dtype)
                    if ctrl_excess <= 1.0:
                        fail(f"{what}: a control (bias or mask dropped) passes the check")
                    min_control = min(min_control, ctrl_excess)
                del controls, ctrl
                k_ms = time_ms(lambda: WA_KERNEL(*args))
                p_ms = time_ms(lambda: _wa.window_attention_plain(*args), reps=5, samples=3)
                # library yardstick: SDPA on pre-partitioned q/k/v (partition
                # and reverse copies excluded), bias + mask as a float mask
                d = c // heads
                x = qkv.reshape(BATCH, hp // WS, WS, hp // WS, WS, 3, heads, d)
                x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, BATCH, nw * heads, nt, d)
                q, k, v = x[0].contiguous(), x[1].contiguous(), x[2].contiguous()
                am = bias[None] + (mask[:, None] if mask is not None else 0.0)
                am = am.expand(nw, heads, nt, nt).reshape(nw * heads, nt, nt).to(dtype)
                lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=scale)
                l_ms = time_ms(lib, reps=5, samples=3)
                es = qkv.element_size()
                nbytes = qkv.numel() * es + qkv.numel() // 3 * es + bias.numel() * 4 + (
                    mask.numel() * 4 if mask is not None else 0)
                flops = 4.0 * BATCH * nw * heads * nt * nt * d
                b_ms, kind = bound_ms(nbytes, flops, dtype)
                log(f"  window_attention {hp}x{hp} C={c} H={heads} shift={int(shifted)} "
                    f"{str(dtype)[6:]}: max_abs_err={err:.3e} err/tol={excess:.3f} "
                    f"(tol atol+rtol|ref| {TOL_WA[dtype]}) control err/tol>={ctrl_excess:.1f} "
                    f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({kind}) blocks/forward={n_blocks}")
                if dtype == torch.bfloat16:  # the serving path's dtype
                    per_forward["ms"] += n_blocks * k_ms
                    per_forward["plain_ms"] += n_blocks * p_ms
                    per_forward["library_ms"] += n_blocks * l_ms
                    per_forward["bound_ms"] += n_blocks * b_ms
                    bound_kinds[kind] += n_blocks * b_ms
                del qkv, out, ref, q, k, v, am
    torch.cuda.empty_cache()
    log(f"  window attention controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return {"max_abs_err": max_err, "bound_by": max(bound_kinds, key=bound_kinds.get),
            **per_forward}


def check_gpf(g: torch.Generator, n: int, d: int) -> dict:
    """Forward kernel at [64, n, d]: the Swin path's (49, 1024) or the ViT
    path's (196, 768)."""
    dev = torch.device("cuda")
    coeffs = torch.nn.functional.softplus(torch.rand(3, 3, generator=g, device=dev) * 0.1)
    worst = 0.0
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        ta = torch.randn(BATCH, n, d, generator=g, device=dev).to(dtype)
        tp = torch.randn(BATCH, n, d, generator=g, device=dev).to(dtype)
        for sim in ("dot", "cosine"):
            for same in (True, False):
                pos = ta if same else tp
                args = (ta, pos, coeffs, sim, 1e-6, True)
                out = GPF_KERNEL(*args)
                ref = _gpf.gpf_plain(*args)
                err_scale = _gpf.gpf_error_scale(*args)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                excess = gpf_excess(out, ref, err_scale)
                if not math.isfinite(excess) or excess > 1.0:
                    fail(f"gpf {sim} same={same} {dtype}: error {excess:.3f}x its tolerance "
                         f"{TOL_GPF} x gpf_error_scale (max abs err {err})")
                worst = max(worst, excess)
                # control: the output with its off-diagonal entries zeroed must fail
                ctrl = out * torch.eye(n, device=dev)
                ctrl_excess = gpf_excess(ctrl, ref, err_scale)
                if ctrl_excess <= 1.0:
                    fail(f"gpf {sim} same={same} {dtype}: zeroed off-diagonal passes the check")
                del ctrl, err_scale
                k_ms = time_ms(lambda: GPF_KERNEL(*args))
                p_ms = time_ms(lambda: _gpf.gpf_plain(*args), reps=5, samples=3)
                tf = ta.float()
                l_ms = time_ms(lambda: torch.bmm(tf, tf.transpose(1, 2)), reps=10, samples=3)
                n_in = 1 if same else 2
                nbytes = n_in * ta.numel() * ta.element_size() + BATCH * n * n * 4 + 36
                # the least work is the upper triangle of each symmetric Gram
                # (diagonal included); the full Gram's figure is kept beside it
                flops = n_in * 2.0 * BATCH * d * n * (n + 1) / 2
                b_ms, kind = bound_ms(nbytes, flops, dtype)
                full_ms, full_kind = bound_ms(nbytes, n_in * 2.0 * BATCH * n * n * d, dtype)
                log(f"  gpf [{BATCH},{n},{d}] {sim} same_tokens={int(same)} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3e} err/tol={excess:.4f} (tol {TOL_GPF} x "
                    f"gpf_error_scale) control err/tol={ctrl_excess:.3e} kernel_ms={k_ms:.4f} "
                    f"plain_ms={p_ms:.4f} library_ms(bmm Gram)={l_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({kind}; upper triangle) full-Gram "
                    f"bound_ms={full_ms:.4f} ({full_kind})")
                if dtype == torch.bfloat16 and sim == "dot" and same:  # the serving call
                    main = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": kind,
                            "full_gram_bound_ms": full_ms}
    # max_abs_err is the serving call's, in its own units (dot Grams of
    # unit-variance tokens reach ~1e12 on the diagonal after the degree-4
    # terms); err_over_tol is the worst over every check
    return {"err_over_tol": worst, **main}


def close_excess(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    ref = ref.float()
    return ((out.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def check_window_attention_bwd(g: torch.Generator) -> dict:
    """Backward kernel vs its plain version at the training shapes (batch
    128); also times the forward kernel at that batch."""
    dev = torch.device("cuda")
    nt = WS * WS
    batch = TRAIN_VIEWS
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=dev)
    per_step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "library_no_dbias_ms": 0.0, "fwd_ms": 0.0}
    max_err = 0.0
    worst = 0.0
    min_control = math.inf
    bound_kinds = {"bytes": 0.0, "operations": 0.0}
    for hp, c, heads, blocks in STAGES:
        table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=dev) * BIAS_TABLE_STD
        bias = table[idx].reshape(nt, nt, heads).permute(2, 0, 1).contiguous()
        nw = (hp // WS) ** 2
        d = c // heads
        scale = d ** -0.5
        for shifted in ((False, True) if hp > WS else (False,)):
            mask = (torch.as_tensor(_attn_mask(hp, hp, hp, hp, WS, WS // 2), device=dev)
                    if shifted else None)
            n_blocks = blocks if hp == WS else (blocks // 2 if shifted else blocks - blocks // 2)
            for dtype in (torch.bfloat16, torch.float32):
                atol, rtol, btol = TOL_WA_BWD[dtype]
                qkv = torch.randn(batch, hp, hp, 3 * c, generator=g, device=dev).to(dtype)
                dout = torch.randn(batch, hp, hp, c, generator=g, device=dev).to(dtype)
                args = (qkv, bias, mask, dout, heads, WS, scale)
                dqkv, dbias = WA_BWD_KERNEL(*args)
                ref_dqkv, ref_dbias = _wa.window_attention_bwd_plain(*args)
                torch.cuda.synchronize()
                what = f"window attention backward {hp}x{hp} C={c} shift={shifted} {dtype}"
                err = (dqkv.float() - ref_dqkv.float()).abs().max().item()
                excess = close_excess(dqkv, ref_dqkv, atol, rtol)
                bias_scale = ref_dbias.abs().max().item()
                bias_err = (dbias - ref_dbias).abs().max().item()
                bias_excess = bias_err / (btol * bias_scale)
                if not math.isfinite(excess) or excess > 1.0:
                    fail(f"{what}: dqkv error {excess:.3f}x its tolerance (max abs err {err})")
                if not math.isfinite(bias_excess) or bias_excess > 1.0:
                    fail(f"{what}: dbias error {bias_err} is {bias_excess:.3f}x its tolerance "
                         f"{btol} x max |dbias| {bias_scale}")
                max_err = max(max_err, err)
                worst = max(worst, excess, bias_excess)
                # controls: dK zeroed in dqkv, and dbias dropped, must both fail
                ctrl = ref_dqkv.clone()
                ctrl[..., c:2 * c] = 0
                ctrl_excess = close_excess(ctrl, ref_dqkv, atol, rtol)
                ctrl_bias = bias_scale / (btol * bias_scale)  # |0 - ref| at its largest entry
                if ctrl_excess <= 1.0 or ctrl_bias <= 1.0:
                    fail(f"{what}: a control (dK zeroed, dbias dropped) passes the check")
                min_control = min(min_control, ctrl_excess, ctrl_bias)
                del ctrl, ref_dqkv, dqkv
                k_ms = time_ms(lambda: WA_BWD_KERNEL(*args), reps=10, samples=3)
                p_ms = time_ms(lambda: _wa.window_attention_bwd_plain(*args), reps=3, samples=3)
                f_ms = time_ms(lambda: WA_KERNEL(qkv, bias, mask, heads, WS, scale), reps=10,
                               samples=3)
                # library yardsticks: the backward of SDPA on pre-partitioned
                # q/k/v with bias + mask as a float mask, with the bias
                # gradient (the same function) and without it (part of it)
                l_ms = time_ms(window_sdpa_backward(qkv, bias, mask, heads, dbias=False), reps=5,
                               samples=3)
                ld_ms = time_ms(window_sdpa_backward(qkv, bias, mask, heads, dbias=True), reps=5,
                                samples=3)
                es = qkv.element_size()
                nbytes = (2 * qkv.numel() + dout.numel()) * es + 2 * bias.numel() * 4 + (
                    mask.numel() * 4 if mask is not None else 0)
                flops = 10.0 * batch * nw * heads * nt * nt * d
                b_ms, kind = bound_ms(nbytes, flops, dtype)
                log(f"  window_attention_bwd {hp}x{hp} C={c} H={heads} shift={int(shifted)} "
                    f"{str(dtype)[6:]} batch {batch}: dqkv max_abs_err={err:.3e} "
                    f"err/tol={excess:.3f} (tol {atol}+{rtol:.4f}|ref|) dbias err={bias_err:.3e} "
                    f"of max {bias_scale:.3e} err/tol={bias_excess:.3f} control err/tol>="
                    f"{min(ctrl_excess, ctrl_bias):.1f} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms(SDPA backward, no dbias)={l_ms:.4f} (with dbias {ld_ms:.4f}) "
                    f"bound_ms={b_ms:.4f} ({kind}) "
                    f"fwd_kernel_ms={f_ms:.4f} blocks/step={n_blocks}")
                if dtype == torch.bfloat16:  # the training path's dtype
                    per_step["ms"] += n_blocks * k_ms
                    per_step["plain_ms"] += n_blocks * p_ms
                    per_step["library_ms"] += n_blocks * ld_ms
                    per_step["library_no_dbias_ms"] += n_blocks * l_ms
                    per_step["bound_ms"] += n_blocks * b_ms
                    per_step["fwd_ms"] += n_blocks * f_ms
                    bound_kinds[kind] += n_blocks * b_ms
                del qkv, dout, args
                torch.cuda.empty_cache()
    log(f"  window attention backward controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return {"max_abs_err": max_err, "err_over_tol": worst,
            "bound_by": max(bound_kinds, key=bound_kinds.get), **per_step}


def check_gpf_bwd(g: torch.Generator, n: int, d: int) -> dict:
    dev = torch.device("cuda")
    coeffs = torch.nn.functional.softplus(torch.rand(3, 3, generator=g, device=dev) * 0.1)
    worst = 0.0
    main = {}

    def rows_excess(out, ref, tol):
        scale = ref.float().abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
        return ((out.float() - ref.float()).abs() / (tol * scale)).max().item()

    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL_GPF_BWD[dtype]
        ta = torch.randn(BATCH, n, d, generator=g, device=dev).to(dtype)
        tp = torch.randn(BATCH, n, d, generator=g, device=dev).to(dtype)
        for sim in ("dot", "cosine"):
            # the same-tensor case once, in the training dtype and similarity
            cases = (False, True) if (dtype == torch.bfloat16 and sim == "dot") else (False,)
            for same in cases:
                pos = ta if same else tp
                # a random cotangent, zeroed on the clamp's kink
                pre = gpf_fuse(token_similarity_graph(ta, sim, 1e-6),
                               token_similarity_graph(pos, sim, 1e-6), coeffs,
                               symmetric_enforce=True, clamp=False)
                band = 1e-4 * _gpf.gpf_error_scale(ta, pos, coeffs, sim, 1e-6, True)
                cot = torch.randn(BATCH, n, n, generator=g, device=dev)
                cot = torch.where(pre.abs() <= band, torch.zeros_like(cot), cot)
                on_kink = int((pre.abs() <= band).sum().item())
                del pre, band
                args = (ta, pos, coeffs, cot, sim, 1e-6, True)
                dta, dtp, dc = GPF_BWD_KERNEL(*args)
                rta, rtp, rdc = _gpf.gpf_bwd_plain(*args)
                torch.cuda.synchronize()
                what = f"gpf backward {sim} same={same} {dtype}"
                excess = max(rows_excess(dta, rta, tol), rows_excess(dtp, rtp, tol))
                dc_scale = rdc.abs().max().item()
                dc_excess = (dc - rdc).abs().max().item() / (TOL_GPF_DC * dc_scale)
                err = max((dta.float() - rta.float()).abs().max().item(),
                          (dtp.float() - rtp.float()).abs().max().item())
                if not math.isfinite(excess) or excess > 1.0:
                    fail(f"{what}: token gradient error {excess:.3f}x its tolerance {tol} x "
                         f"row max (max abs err {err})")
                if not math.isfinite(dc_excess) or dc_excess > 1.0:
                    fail(f"{what}: dc error {dc_excess:.3f}x its tolerance {TOL_GPF_DC} x max")
                worst = max(worst, excess, dc_excess)
                # controls: the dR^T half of dX dropped (dR is symmetric here,
                # so half the gradient), and dc zeroed
                ctrl_excess = rows_excess(0.5 * rta.float(), rta, tol)
                ctrl_dc = dc_scale / (TOL_GPF_DC * dc_scale)
                if ctrl_excess <= 1.0 or ctrl_dc <= 1.0:
                    fail(f"{what}: a control (half of dX dropped, dc zeroed) passes the check")
                if same:
                    # autograd must add the two token gradients of one tensor
                    x = ta.clone().requires_grad_()
                    _gpf.gpf(x, x, coeffs, sim, 1e-6, True).backward(cot)
                    total = rta.float() + rtp.float()
                    sum_excess = rows_excess(x.grad, total, tol)
                    if not math.isfinite(sum_excess) or sum_excess > 1.0:
                        fail(f"{what}: the summed gradient of one tensor used twice is off "
                             f"({sum_excess:.3f}x its tolerance)")
                    if rows_excess(rta, total, tol) <= 1.0:
                        fail(f"{what}: one gradient alone passes for the sum of both")
                    del x, total
                k_ms = time_ms(lambda: GPF_BWD_KERNEL(*args))
                p_ms = time_ms(lambda: _gpf.gpf_bwd_plain(*args), reps=5, samples=3)
                # library yardstick (part of the work only): autograd through
                # one bmm Gram
                tf = ta.float().requires_grad_()
                gram = torch.bmm(tf, tf.transpose(1, 2))
                l_ms = time_ms(lambda: torch.autograd.grad(gram, tf, cot, retain_graph=True),
                               reps=10, samples=3)
                del tf, gram
                n_in = 1 if same else 2
                es = ta.element_size()
                nbytes = (n_in + 2) * ta.numel() * es + BATCH * n * n * 4 + BATCH * 36 + 36
                flops = 8.0 * BATCH * n * n * d
                b_ms, kind = bound_ms(nbytes, flops, dtype)
                log(f"  gpf_bwd [{BATCH},{n},{d}] {sim} same_tokens={int(same)} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3e} err/tol={excess:.4f} (tol {tol} x row max) dc "
                    f"err/tol={dc_excess:.4f} control err/tol={min(ctrl_excess, ctrl_dc):.1f} "
                    f"cotangent entries zeroed on the kink: {on_kink} kernel_ms={k_ms:.4f} "
                    f"plain_ms={p_ms:.4f} library_ms(bmm Gram backward)={l_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({kind}, {nbytes / 1e6:.1f} MB)")
                if dtype == torch.bfloat16 and sim == "dot" and not same:  # the training call
                    f_ms = time_ms(lambda: GPF_KERNEL(ta, tp, coeffs, sim, 1e-6, True))
                    # its two launches apart: the w kernel, the dX kernel
                    split = launch_split(lambda: GPF_BWD_KERNEL(*args))
                    log(f"  gpf_bwd [{BATCH},{n},{d}] launches a call (torch.profiler): "
                        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
                    main = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                            "bound_ms": b_ms, "bound_by": kind, "fwd_ms": f_ms,
                            "launch_ms": split}
    return {"err_over_tol": worst, **main}


# packed-layout attention shapes: (name, W, T, C, heads, bias heads, mask groups,
# launches per ViT-Base forward).  The ViT-Base call is the main path's; the
# ViT-Tiny call has three heads of 64; the Swin packed shape (two windows of 49
# per group at stage 0) switches on a per-head bias with a -100 block seal
# between the two windows and a per-group mask, and heads of 32.
PACKED_SHAPES = (
    ("vit_base", 1, VIT_T, VIT_C, VIT_H, 0, 0, VIT_DEPTH),
    ("vit_tiny", 1, VIT_T, 192, 3, 0, 0, 0),
    ("swin_packed", 32, 98, 128, 4, 4, 32, 0),
)


def packed_inputs(g, batch, w, t, c, heads, hb, wm, dtype):
    dev = torch.device("cuda")
    qkv = torch.randn(batch, w, t, 3 * c, generator=g, device=dev).to(dtype)
    bias = mask = None
    if hb:
        bias = torch.randn(hb, t, t, generator=g, device=dev) * BIAS_TABLE_STD
        half = t // 2  # the seal between the two packed windows
        bias[:, :half, half:] = -100.0
        bias[:, half:, :half] = -100.0
    if wm:
        mask = torch.where(torch.rand(wm, t, t, generator=g, device=dev) < 0.2, -100.0, 0.0)
    return qkv, bias, mask


def sdpa_inputs(qkv, bias, mask, heads):
    """q, k, v [B*W, H, T, d] and the float mask SDPA takes, from the packed layout."""
    b, w, t, c3 = qkv.shape
    d = c3 // 3 // heads
    x = qkv.reshape(b * w, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    am = None
    if bias is not None or mask is not None:
        am = torch.zeros(b, w, heads, t, t, dtype=torch.float32, device=qkv.device)
        if bias is not None:
            am = am + bias[None, None]
        if mask is not None:
            am = am + mask[None, :, None]
        am = am.reshape(b * w, heads, t, t).to(qkv.dtype)
    return x[0].contiguous(), x[1].contiguous(), x[2].contiguous(), am


def check_packed_attention(g: torch.Generator) -> dict:
    main = {}
    min_control = math.inf
    for name, w, t, c, heads, hb, wm, per_forward in PACKED_SHAPES:
        d = c // heads
        for dtype in (torch.bfloat16, torch.float32):
            qkv, bias, mask = packed_inputs(g, BATCH, w, t, c, heads, hb, wm, dtype)
            args = (qkv, bias, mask, heads)
            out = PA_KERNEL(*args)
            ref, ref_lse = _pa.packed_attention_plain(*args, return_lse=True)
            out_lse, lse = PA_KERNEL(*args, return_lse=True)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            excess = wa_excess(out, ref, dtype)
            what = f"packed attention {name} [{BATCH},{w},{t},{3 * c}] H={heads} {dtype}"
            if not math.isfinite(excess) or excess > 1.0:
                fail(f"{what}: error {excess:.3f}x its tolerance {TOL_WA[dtype]} (max abs err "
                     f"{err})")
            # the log-sum-exp the training forward writes, and the same output
            lse_err = (lse - ref_lse).abs().max().item()
            if not torch.equal(out_lse, out) or not lse_err <= 1e-4 * ref_lse.abs().max().item():
                fail(f"{what}: with lse the output differs or lse is off by {lse_err}")
            again, lse_again = PA_KERNEL(*args, return_lse=True)  # twice, bit for bit
            if not torch.equal(again, out) or not torch.equal(lse_again, lse):
                fail(f"{what}: two runs of the forward kernel differ")
            del out_lse, lse, ref_lse, again, lse_again
            # controls: the keys padded up to the kernel's tile and left
            # unmasked (zero keys join the softmax), and the bias dropped
            pad = -(-t // _pa.TILE) * _pa.TILE - t
            padded = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
            pb = None if bias is None else torch.nn.functional.pad(bias, (0, pad, 0, pad))
            pm = None if mask is None else torch.nn.functional.pad(mask, (0, pad, 0, pad))
            ctrl_excess = wa_excess(
                _pa.packed_attention_plain(padded, pb, pm, heads)[:, :, :t], ref, dtype)
            if bias is not None:
                ctrl_excess = min(ctrl_excess, wa_excess(
                    _pa.packed_attention_plain(qkv, None, mask, heads), ref, dtype))
            if ctrl_excess <= 1.0:
                fail(f"{what}: a control (padded keys unmasked, bias dropped) passes the check")
            min_control = min(min_control, ctrl_excess)
            del padded, pb, pm
            reps = 20 if dtype == torch.bfloat16 else 5
            k_ms = time_ms(lambda: PA_KERNEL(*args), reps=reps, samples=3)
            p_ms = time_ms(lambda: _pa.packed_attention_plain(*args), reps=3, samples=3)
            q, k, v, am = sdpa_inputs(qkv, bias, mask, heads)
            l_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=am, scale=d ** -0.5), reps=5, samples=3)
            es = qkv.element_size()
            nbytes = qkv.numel() * es + qkv.numel() // 3 * es + (
                bias.numel() * 4 if bias is not None else 0) + (
                mask.numel() * 4 if mask is not None else 0)
            flops = 4.0 * BATCH * w * heads * t * t * d
            b_ms, kind = bound_ms(nbytes, flops, dtype)
            log(f"  packed_attention {name} [{BATCH},{w},{t},{3 * c}] H={heads} "
                f"{str(dtype)[6:]}: max_abs_err={err:.3e} err/tol={excess:.3f} (tol atol+rtol|ref| "
                f"{TOL_WA[dtype]}) lse max_abs_err={lse_err:.3e} two runs equal; "
                f"control err/tol>={ctrl_excess:.1f} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms(SDPA)={l_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({kind}) GB/s={nbytes / k_ms / 1e6:.0f} "
                f"(SDPA {nbytes / l_ms / 1e6:.0f}) TFLOP/s(4T^2d)={flops / k_ms / 1e9:.1f} "
                f"(SDPA {flops / l_ms / 1e9:.1f})")
            if per_forward and dtype == torch.bfloat16:  # the serving path's call
                main = {"max_abs_err": err, "ms": per_forward * k_ms,
                        "plain_ms": per_forward * p_ms, "library_ms": per_forward * l_ms,
                        "bound_ms": per_forward * b_ms, "bound_by": kind,
                        "gb_per_s": nbytes / k_ms / 1e6, "library_gb_per_s": nbytes / l_ms / 1e6}
            del qkv, out, ref, q, k, v, am
            torch.cuda.empty_cache()
    log(f"  packed attention controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return main


def issued_tflops(batch: int, heads: int, t: int, d: int, ms: float) -> float:
    """The attention backward's seven T x T x d products (two rebuilt, none
    skipped), 14 T^2 d flops per (image, head), over ``ms``: TFLOP/s."""
    return 14.0 * batch * heads * t * t * d / ms / 1e9


def sdpa_forward_ms(qkv: torch.Tensor, bias, mask, heads: int) -> float:
    """Library yardstick of the forward at a training call: SDPA on the same
    inputs (without the log-sum-exp the kernel also writes there)."""
    d = qkv.shape[-1] // 3 // heads
    q, k, v, am = sdpa_inputs(qkv, bias, mask, heads)
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=am, scale=d ** -0.5), reps=5, samples=3)


def sdpa_backward_ms(qkv: torch.Tensor, bias, mask, heads: int, reps: int) -> float:
    """Library yardstick: the backward of SDPA on the same inputs (dq, dk, dv;
    no bias gradient, so with a bias it does part of the work only)."""
    d = qkv.shape[-1] // 3 // heads
    q, k, v, am = sdpa_inputs(qkv, bias, mask, heads)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=d ** -0.5)
    do = torch.randn_like(o)
    return time_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True), reps=reps,
                   samples=3)


def check_packed_attention_bwd(g: torch.Generator) -> dict:
    """Backward kernel vs its plain version at the training shapes (batch 128
    for the ViT calls, 64 for the Swin packed shape), both from the forward
    kernel's out and lse; also times the forward kernel at that batch."""
    main = {}
    worst = 0.0
    min_control = math.inf
    for name, w, t, c, heads, hb, wm, per_step in PACKED_SHAPES:
        d = c // heads
        batch = TRAIN_VIEWS if w == 1 else BATCH
        for dtype in (torch.bfloat16, torch.float32):
            atol, rtol, btol = TOL_WA_BWD[dtype]
            qkv, bias, mask = packed_inputs(g, batch, w, t, c, heads, hb, wm, dtype)
            dout = torch.randn(batch, w, t, c, generator=g, device=qkv.device).to(dtype)
            out, lse = PA_KERNEL(qkv, bias, mask, heads, return_lse=True)
            args = (qkv, bias, mask, out, lse, dout, heads)
            dqkv, dbias = PA_BWD_KERNEL(*args)
            ref_dqkv, ref_dbias = _pa.packed_attention_bwd_plain(*args)
            torch.cuda.synchronize()
            what = f"packed attention backward {name} [{batch},{w},{t},{3 * c}] {dtype}"
            err = (dqkv.float() - ref_dqkv.float()).abs().max().item()
            excess = close_excess(dqkv, ref_dqkv, atol, rtol)
            if not math.isfinite(excess) or excess > 1.0:
                fail(f"{what}: dqkv error {excess:.3f}x its tolerance (max abs err {err})")
            bias_excess, bias_err, bias_scale = 0.0, 0.0, 0.0
            if bias is not None:
                bias_scale = ref_dbias.abs().max().item()
                bias_err = (dbias - ref_dbias).abs().max().item()
                bias_excess = bias_err / (btol * bias_scale)
                if not math.isfinite(bias_excess) or bias_excess > 1.0:
                    fail(f"{what}: dbias error {bias_err} is {bias_excess:.3f}x its tolerance "
                         f"{btol} x max |dbias| {bias_scale}")
            worst = max(worst, excess, bias_excess)
            # the same gradient twice, bit for bit
            again, dbias_again = PA_BWD_KERNEL(*args)
            if not torch.equal(again, dqkv) or (
                    dbias is not None and not torch.equal(dbias_again, dbias)):
                fail(f"{what}: two runs of the backward kernel differ")
            # controls: dK zeroed in dqkv, and dbias dropped, must both fail
            ctrl = ref_dqkv.clone()
            ctrl[..., c:2 * c] = 0
            ctrl_excess = close_excess(ctrl, ref_dqkv, atol, rtol)
            if bias is not None:  # |0 - ref| at its largest entry
                ctrl_excess = min(ctrl_excess, bias_scale / (btol * bias_scale))
            if ctrl_excess <= 1.0:
                fail(f"{what}: a control (dK zeroed, dbias dropped) passes the check")
            min_control = min(min_control, ctrl_excess)
            del ctrl, ref_dqkv, dqkv, again
            reps = 10 if dtype == torch.bfloat16 else 3
            k_ms = time_ms(lambda: PA_BWD_KERNEL(*args), reps=reps, samples=3)
            p_ms = time_ms(lambda: _pa.packed_attention_bwd_plain(*args), reps=2, samples=3)
            f_ms = time_ms(lambda: PA_KERNEL(qkv, bias, mask, heads, return_lse=True), reps=reps,
                           samples=3)
            fl_ms = sdpa_forward_ms(qkv, bias, mask, heads)
            l_ms = sdpa_backward_ms(qkv, bias, mask, heads, reps=5)
            es = qkv.element_size()
            # qkv, out, dout and lse read, dqkv written (bias and mask read,
            # dbias written); the minimal work is the five products of the
            # backward, 10 T^2 d flops per (image, group, head)
            nbytes = (2 * qkv.numel() + 2 * dout.numel()) * es + lse.numel() * 4 + (
                2 * bias.numel() * 4 if bias is not None else 0) + (
                mask.numel() * 4 if mask is not None else 0)
            flops = 10.0 * batch * w * heads * t * t * d
            b_ms, kind = bound_ms(nbytes, flops, dtype)
            log(f"  packed_attention_bwd {name} [{batch},{w},{t},{3 * c}] H={heads} "
                f"{str(dtype)[6:]}: dqkv max_abs_err={err:.3e} err/tol={excess:.3f} (tol "
                f"{atol}+{rtol:.4f}|ref|) dbias err={bias_err:.3e} of max {bias_scale:.3e} "
                f"err/tol={bias_excess:.3f} two runs equal; control err/tol>={ctrl_excess:.1f} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms(SDPA backward)={l_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({kind}) "
                f"TFLOP/s(14T^2d)={issued_tflops(batch * w, heads, t, d, k_ms):.1f} "
                f"fwd_kernel_ms={f_ms:.4f} (SDPA {fl_ms:.4f})")
            if per_step and dtype == torch.bfloat16:  # the training path's call
                main = {"max_abs_err": err, "ms": per_step * k_ms, "plain_ms": per_step * p_ms,
                        "library_ms": per_step * l_ms, "bound_ms": per_step * b_ms,
                        "bound_by": kind, "fwd_ms": per_step * f_ms,
                        "fwd_library_ms": per_step * fl_ms}
            del qkv, dout, out, lse, args
            torch.cuda.empty_cache()
    log(f"  packed attention backward controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return {"err_over_tol": worst, **main}


def check_flash_attention(g: torch.Generator, t: int = VIT448_T, c: int = VIT_C,
                          heads: int = VIT_H, depth: int = VIT_DEPTH) -> dict:
    """Kernel 6 at a serving call, bf16 and fp32, with the log-sum-exp it
    writes for the backward: ViT-Base at 448, qkv [64, 785, 2304] (the
    default), or ViT-Large at 512, [64, 1025, 3072] with 16 heads.  The
    per-forward sums count ``depth`` launches."""
    d = c // heads
    main = {}
    min_control = math.inf
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL_FA[dtype]
        qkv = torch.randn(BATCH, t, 3 * c, generator=g, device="cuda").to(dtype)
        out, lse = FA_KERNEL(qkv, heads)
        ref, ref_lse = _fa.flash_attention_tiled_plain(qkv, heads)
        torch.cuda.synchronize()
        what = f"q-tiled attention [{BATCH},{t},{3 * c}] H={heads} {dtype}"
        err = (out.float() - ref.float()).abs().max().item()
        excess = close_excess(out, ref, atol, rtol)
        lse_err = (lse - ref_lse).abs().max().item()
        if not math.isfinite(excess) or excess > 1.0:
            fail(f"{what}: error {excess:.3f}x its tolerance {TOL_FA[dtype]} (max abs err {err})")
        if not lse_err <= 1e-4 * ref_lse.abs().max().item():
            fail(f"{what}: log-sum-exp off by {lse_err}")
        again, lse_again = FA_KERNEL(qkv, heads)  # twice, bit for bit
        if not torch.equal(again, out) or not torch.equal(lse_again, lse):
            fail(f"{what}: two runs of the forward kernel differ")
        del again, lse_again
        # controls: the keys padded up to the kernel's tile and left unmasked
        # (zero keys join the softmax), and only the first tile of keys
        pad = -(-t // _fa.TILE) * _fa.TILE - t
        padded = torch.nn.functional.pad(qkv, (0, 0, 0, pad))
        controls = (_fa.flash_attention_tiled_plain(padded, heads)[0][:, :t],
                    first_keys_attention(qkv, heads)[0])
        ctrl_excess = min(close_excess(ctrl, ref, atol, rtol) for ctrl in controls)
        if ctrl_excess <= 1.0:
            fail(f"{what}: a control (padded keys unmasked, first 64 keys only) passes the check")
        min_control = min(min_control, ctrl_excess)
        del padded, controls
        reps = 10 if dtype == torch.bfloat16 else 3
        k_ms = time_ms(lambda: FA_KERNEL(qkv, heads), reps=reps, samples=3)
        p_ms = time_ms(lambda: _fa.flash_attention_tiled_plain(qkv, heads), reps=3, samples=3)
        q, k, v, _ = sdpa_inputs(qkv[:, None], None, None, heads)
        l_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5), reps=5, samples=3)
        nbytes = qkv.numel() * qkv.element_size() * 4 / 3 + lse.numel() * 4
        flops = 4.0 * BATCH * heads * t * t * d
        b_ms, kind = bound_ms(nbytes, flops, dtype)
        log(f"  flash_attention_tiled [{BATCH},{t},{3 * c}] H={heads} {str(dtype)[6:]}: "
            f"max_abs_err={err:.3e} err/tol={excess:.3f} (tol atol+rtol|ref| {TOL_FA[dtype]}) "
            f"lse max_abs_err={lse_err:.3e} two runs equal; control err/tol>={ctrl_excess:.1f} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms(SDPA)={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({kind}) TFLOP/s(4T^2d)={flops / k_ms / 1e9:.1f} "
            f"(SDPA {flops / l_ms / 1e9:.1f})")
        if dtype == torch.bfloat16:  # the serving path's call, depth per forward
            main = {"max_abs_err": err, "ms": depth * k_ms, "plain_ms": depth * p_ms,
                    "library_ms": depth * l_ms, "bound_ms": depth * b_ms,
                    "bound_by": kind, "tflops": flops / k_ms / 1e9,
                    "library_tflops": flops / l_ms / 1e9}
        del qkv, out, lse, ref, ref_lse, q, k, v
        torch.cuda.empty_cache()
    log(f"  q-tiled attention controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return main


def check_flash_attention_bwd(g: torch.Generator, t: int = VIT448_T, c: int = VIT_C,
                              heads: int = VIT_H, depth: int = VIT_DEPTH,
                              plain_batch: int = TRAIN_VIEWS) -> dict:
    """Kernel 6b at a training call (batch 128), from the forward kernel's out
    and lse: ViT-Base at 448, qkv [128, 785, 2304] (the default), or
    ViT-Large at 512, [128, 1025, 3072] with 16 heads, bf16 only (its fp32
    plain version would hold ~45 GB).  The plain version runs on the first
    ``plain_batch`` images; the per-step sums count ``depth`` launches.  Also
    times the forward kernel at that batch."""
    d = c // heads
    batch = TRAIN_VIEWS
    main = {}
    worst = 0.0
    min_control = math.inf
    dtypes = (torch.bfloat16, torch.float32) if plain_batch == batch else (torch.bfloat16,)
    for dtype in dtypes:
        atol, rtol = TOL_FA_BWD[dtype]
        qkv = torch.randn(batch, t, 3 * c, generator=g, device="cuda").to(dtype)
        dout = torch.randn(batch, t, c, generator=g, device="cuda").to(dtype)
        out, lse = FA_KERNEL(qkv, heads)
        args = (qkv, out, lse, dout, heads)
        dqkv = FA_BWD_KERNEL(*args)[:plain_batch]
        ref = _fa.flash_attention_tiled_bwd_plain(qkv[:plain_batch], dout[:plain_batch], heads)
        torch.cuda.synchronize()
        what = f"q-tiled attention backward [{batch},{t},{3 * c}] H={heads} {dtype}"
        err = (dqkv.float() - ref.float()).abs().max().item()
        excess = close_excess(dqkv, ref, atol, rtol)
        if not math.isfinite(excess) or excess > 1.0:
            fail(f"{what}: dqkv error {excess:.3f}x its tolerance (max abs err {err})")
        worst = max(worst, excess)
        if not torch.equal(FA_BWD_KERNEL(*args)[:plain_batch], dqkv):  # twice, bit for bit
            fail(f"{what}: two runs of the backward kernel differ")
        ctrl = ref.clone()
        ctrl[..., c:2 * c] = 0  # control: dK zeroed
        ctrl_excess = close_excess(ctrl, ref, atol, rtol)
        if ctrl_excess <= 1.0:
            fail(f"{what}: a control (dK zeroed) passes the check")
        min_control = min(min_control, ctrl_excess)
        del ctrl, ref, dqkv
        reps = 5 if dtype == torch.bfloat16 else 2
        k_ms = time_ms(lambda: FA_BWD_KERNEL(*args), reps=reps, samples=3)
        p_ms = time_ms(lambda: _fa.flash_attention_tiled_bwd_plain(
            qkv[:plain_batch], dout[:plain_batch], heads), reps=2, samples=3)
        f_ms = time_ms(lambda: FA_KERNEL(qkv, heads), reps=reps, samples=3)
        fl_ms = sdpa_forward_ms(qkv[:, None], None, None, heads)
        l_ms = sdpa_backward_ms(qkv[:, None], None, None, heads, reps=3)
        es = qkv.element_size()
        nbytes = (2 * qkv.numel() + 2 * dout.numel()) * es + lse.numel() * 4
        flops = 10.0 * batch * heads * t * t * d
        b_ms, kind = bound_ms(nbytes, flops, dtype)
        log(f"  flash_attention_tiled_bwd [{batch},{t},{3 * c}] H={heads} {str(dtype)[6:]}: "
            f"dqkv max_abs_err={err:.3e} err/tol={excess:.3f} (tol {atol}+{rtol:.4f}|ref|, "
            f"first {plain_batch} images) two runs equal; control err/tol>={ctrl_excess:.1f} "
            f"kernel_ms={k_ms:.4f} plain_ms(batch {plain_batch})={p_ms:.4f} "
            f"library_ms(SDPA backward)={l_ms:.4f} bound_ms={b_ms:.4f} ({kind}) "
            f"TFLOP/s(14T^2d)={issued_tflops(batch, heads, t, d, k_ms):.1f} "
            f"fwd_kernel_ms={f_ms:.4f} (SDPA {fl_ms:.4f})")
        if dtype == torch.bfloat16:  # the training path's call, depth per step
            main = {"max_abs_err": err, "ms": depth * k_ms, "plain_ms": depth * p_ms,
                    "plain_batch": plain_batch, "library_ms": depth * l_ms,
                    "bound_ms": depth * b_ms, "bound_by": kind, "fwd_ms": depth * f_ms,
                    "fwd_library_ms": depth * fl_ms}
        del qkv, dout, out, lse, args
        torch.cuda.empty_cache()
    log(f"  q-tiled attention backward controls: smallest err/tol {min_control:.1f} "
        "(must be > 1)")
    return {"err_over_tol": worst, **main}


def head_moment_matrix(g: torch.Generator, n: int, d: int) -> torch.Tensor:
    """M2 = Zc^T W Zc in fp32 as the moment head forms it on the dense route,
    from random [64, n, d] tokens and a random non-negative symmetric graph
    (a Gram of non-negative features, so W and M2 are PSD as the head's are)."""
    tokens = torch.randn(BATCH, n, d, generator=g, device="cuda")
    feats = torch.rand(BATCH, n, 16, generator=g, device="cuda")
    w = normalize_graph(torch.matmul(feats, feats.transpose(1, 2)), "symmetric", eps=NS_EPS)
    centered = tokens - graph_weighted_mean(tokens, w, eps=NS_EPS)[:, None, :]
    return torch.matmul(centered.transpose(1, 2), torch.matmul(w, centered))


def ns_excess(out: torch.Tensor, ref: torch.Tensor, dtype, tol=None) -> float:
    """Largest |out - ref| / (rtol |ref| + atol max |ref|); passes at <= 1."""
    rtol, atol = tol or TOL_NS[dtype]
    ref = ref.float()
    return ((out.float() - ref).abs() / (rtol * ref.abs() + atol * ref.abs().max())).max().item()


def check_newton_schulz(g: torch.Generator) -> dict:
    """Kernel 5 at the dense head's call, M [64, 768, 768] (ViT-Base at 448),
    and at [64, 192, 192] (ViT-Tiny at 224), M in bf16 and fp32."""
    main = {}
    min_control = math.inf
    for n, d in ((VIT448_T - 1, VIT_C), (196, 192)):
        m32 = head_moment_matrix(g, n, d)
        for dtype in (torch.bfloat16, torch.float32):
            m = m32.to(dtype)
            out = NS_KERNEL(m, NS_ITERS, NS_EPS)
            ref = _ns.newton_schulz_isqrt_plain(m, NS_ITERS, NS_EPS)
            torch.cuda.synchronize()
            what = f"newton_schulz [{BATCH},{d},{d}] {dtype}"
            err = (out.float() - ref.float()).abs().max().item()
            excess = ns_excess(out, ref, dtype)
            if not math.isfinite(excess) or excess > 1.0:
                fail(f"{what}: error {excess:.3f}x its tolerance {TOL_NS[dtype]} (max abs err "
                     f"{err})")
            # control: four iterations instead of five
            ctrl_excess = ns_excess(_ns.newton_schulz_isqrt_plain(m, NS_ITERS - 1, NS_EPS), ref,
                                    dtype)
            if ctrl_excess <= 1.0:
                fail(f"{what}: a control (four iterations) passes the check")
            min_control = min(min_control, ctrl_excess)
            k_ms = time_ms(lambda: NS_KERNEL(m, NS_ITERS, NS_EPS), reps=3, samples=3)
            p_ms = time_ms(lambda: _ns.newton_schulz_isqrt_plain(m, NS_ITERS, NS_EPS), reps=3,
                           samples=3)

            def library():
                # the same iteration on cuBLAS fp32, each update one baddbmm
                mf = m.float()
                tr = torch.diagonal(mf, dim1=-2, dim2=-1).sum(-1)[:, None, None] + NS_EPS
                z = mf / tr
                y = torch.eye(d, device=m.device).expand_as(z).contiguous()
                for i in range(NS_ITERS):
                    t = torch.bmm(z, y)
                    y_next = torch.baddbmm(y, y, t, beta=1.5, alpha=-0.5)
                    if i + 1 < NS_ITERS:
                        z = torch.baddbmm(z, t.transpose(1, 2), z, beta=1.5, alpha=-0.5)
                    y = y_next
                return (y / torch.sqrt(tr)).to(m.dtype)

            l_ms = time_ms(library, reps=3, samples=3)
            nbytes = 2 * m.numel() * m.element_size()
            # products the function needs: three a step, less the first step's
            # two (Y = I) and the last step's Z update, which nothing reads
            flops = BATCH * (3 * NS_ITERS - 3) * 2.0 * d ** 3
            b_ms, kind = bound_ms(nbytes, flops, torch.float32)  # fp32 inside, whatever M's type
            log(f"  newton_schulz [{BATCH},{d},{d}] k={NS_ITERS} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} of max |ref| {ref.float().abs().max().item():.3e} "
                f"err/tol={excess:.3f} (tol rtol|ref| + atol max|ref| {TOL_NS[dtype]}) control "
                f"err/tol={ctrl_excess:.1f} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"library_ms(cuBLAS fp32 bmm/baddbmm iteration)={l_ms:.4f} bound_ms={b_ms:.4f} "
                f"({kind})")
            if d == VIT_C and dtype == torch.bfloat16:  # the 448 path's call, 1 per forward
                main = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": kind}
            del m, out, ref
        del m32
        torch.cuda.empty_cache()
    log(f"  newton_schulz controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return main


def ns_bf16_library(m: torch.Tensor, streamed: bool) -> torch.Tensor:
    """The bf16 iteration on cuBLAS, at the kernels' rounding points: bf16
    ``bmm`` for the products and ``baddbmm`` for the update, with the first
    step's exact copies skipped as the kernels skip them.  A yardstick, never
    the port's."""
    mf = m.float()
    tr = torch.diagonal(mf, dim1=-2, dim2=-1).sum(-1)[:, None, None] + NS_EPS
    mn = (mf / tr).to(torch.bfloat16)
    eye = torch.eye(m.shape[-1], device=m.device)
    y = (1.5 * eye - 0.5 * mn.float()).to(torch.bfloat16)
    for _ in range(NS_ITERS - 1):
        if streamed:
            p = torch.bmm(torch.bmm(y, mn), y)
            y = torch.baddbmm(y, p, y, beta=1.5, alpha=-0.5)
        else:
            t2 = torch.bmm(mn, torch.bmm(y, y))
            y = torch.baddbmm(y, y, t2, beta=1.5, alpha=-0.5)
    return (y.float() / torch.sqrt(tr)).to(m.dtype)


def check_newton_schulz_bf16(g: torch.Generator) -> dict:
    """Kernels 5′ and 5″ at the dense head's calls: M [64, 1024, 1024] as the
    head builds it for ViT-Large at 512 (N = 1024) and [64, 1536, 1536] for
    Swin-Large at 1280 (N = 1600), M in bf16 and fp32, each against the plain
    version that rounds where it rounds.  Two runs must agree bit for bit;
    four iterations must fail; the other variant's grouping is printed.
    Bound: 3(k - 1) products of 2 D^3 over the bf16 tensor-core peak."""
    results = {}
    min_control = math.inf
    for variant, n, d in (("bf16", VITL_T - 1, VITL_C), ("bf16_streamed", SWINL_N, SWINL_C)):
        kernel, plain, other = NS_BF16_VARIANTS[variant]
        m32 = head_moment_matrix(g, n, d)
        for dtype in (torch.bfloat16, torch.float32):
            m = m32.to(dtype)
            out = kernel(m, NS_ITERS, NS_EPS)
            again = kernel(m, NS_ITERS, NS_EPS)
            ref = plain(m, NS_ITERS, NS_EPS)
            torch.cuda.synchronize()
            what = f"newton_schulz {variant} [{BATCH},{d},{d}] {dtype}"
            if not torch.equal(out, again):
                fail(f"{what}: two runs of the kernel differ")
            # one step is Mn and an elementwise update: the same bits as the
            # plain version, or the two do not normalize alike
            if not torch.equal(kernel(m, 1, NS_EPS), plain(m, 1, NS_EPS)):
                fail(f"{what}: one step differs from the plain version's bits")
            del again
            err = (out.float() - ref.float()).abs().max().item()
            excess = ns_excess(out, ref, dtype, TOL_NS_BF16)
            if not math.isfinite(excess) or excess > 1.0:
                fail(f"{what}: error {excess:.3f}x its tolerance {TOL_NS_BF16} (max abs err "
                     f"{err})")
            # control: four iterations instead of five
            ctrl_excess = ns_excess(plain(m, NS_ITERS - 1, NS_EPS), ref, dtype, TOL_NS_BF16)
            if ctrl_excess <= 1.0:
                fail(f"{what}: a control (four iterations) passes the check")
            min_control = min(min_control, ctrl_excess)
            other_excess = ns_excess(other(m, NS_ITERS, NS_EPS), ref, dtype, TOL_NS_BF16)
            lib_excess = ns_excess(ns_bf16_library(m, variant == "bf16_streamed"), ref, dtype,
                                   TOL_NS_BF16)
            k_ms = time_ms(lambda: kernel(m, NS_ITERS, NS_EPS), reps=3, samples=3)
            p_ms = time_ms(lambda: plain(m, NS_ITERS, NS_EPS), reps=2, samples=3)
            l_ms = time_ms(lambda: ns_bf16_library(m, variant == "bf16_streamed"), reps=3,
                           samples=3)
            nbytes = 2 * m.numel() * m.element_size()
            flops = BATCH * (3 * NS_ITERS - 3) * 2.0 * d ** 3
            b_ms, kind = bound_ms(nbytes, flops, torch.bfloat16)  # bf16 tensor-core products
            log(f"  newton_schulz {variant} [{BATCH},{d},{d}] k={NS_ITERS} {str(dtype)[6:]}: "
                f"max_abs_err={err:.3e} of max |ref| {ref.float().abs().max().item():.3e} "
                f"err/tol={excess:.3f} (tol rtol|ref| + atol max|ref| {TOL_NS_BF16}) two runs "
                f"equal, one step equal to the plain version's bits; control (four iterations) err/tol={ctrl_excess:.1f}; the other "
                f"grouping err/tol={other_excess:.3f} (printed, not enforced); library "
                f"err/tol={lib_excess:.3f} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"library_ms(cuBLAS bf16 bmm/baddbmm iteration)={l_ms:.4f} bound_ms={b_ms:.4f} "
                f"({kind}) TFLOP/s={flops / k_ms / 1e9:.1f} (cuBLAS iteration "
                f"{flops / l_ms / 1e9:.1f})")
            if dtype == torch.bfloat16:  # the serving paths' call, 1 per forward
                results[variant] = {"max_abs_err": err, "err_over_tol": excess, "ms": k_ms,
                                    "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                                    "bound_by": kind, "tflops": flops / k_ms / 1e9,
                                    "library_tflops": flops / l_ms / 1e9}
            del m, out, ref
        del m32
        torch.cuda.empty_cache()
    log(f"  newton_schulz bf16 controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return results


def time_newton_schulz_bwd(g: torch.Generator) -> float:
    """The dense head's iSQRT backward on the ViT-Large/512 training path:
    autograd over the plain fp32 iteration from the saved M [64, 1024, 1024]
    (bf16), as ``NewtonSchulzFunction.backward`` runs it, in ms."""
    m = head_moment_matrix(g, VITL_T - 1, VITL_C).to(torch.bfloat16)
    cot = torch.randn(m.shape, generator=g, device="cuda").to(torch.bfloat16)

    def backward():
        x = m.detach().requires_grad_()
        y = _ns.newton_schulz_isqrt_plain(x, NS_ITERS, NS_EPS)
        return torch.autograd.grad(y, x, cot)

    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(backward, reps=2, samples=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  newton_schulz backward (autograd over the plain fp32 iteration) [{BATCH},{VITL_C},"
        f"{VITL_C}] bf16 M: {ms:.3f} ms, peak memory {peak:.2f} GiB")
    del m, cot
    torch.cuda.empty_cache()
    return ms


def check_window_attention_padded(g: torch.Generator) -> dict:
    """Kernel 1 at the Swin-Large/1280 serving path's own launches: batch 64
    on every stage's padded canvas (322 / 161 / 84 / 42 for 320 / 160 / 80 /
    40 real rows, C 192 .. 1536), unshifted and shifted, both masks holding
    the pad sentinel, bf16 and fp32.  Each launch is held against the plain
    version on the same qkv in slices of PLAIN_SLICE images (where the plain
    version's [B, nW, H, 49, 49] probabilities fit).  Control: the mask
    without the pad sentinel, under which real queries see pad keys (on the
    first slice).  The bf16 launches are then timed, beside SDPA on the same
    inputs and the bytes each must move, and summed over a forward's 24."""
    dev = torch.device("cuda")
    nt = WS * WS
    idx = torch.as_tensor(_relative_position_index(WS).reshape(-1), device=dev)
    max_err, max_excess, min_control = 0.0, 0.0, math.inf
    stage0_ms, total = {}, {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for stage, (h, hp, c, heads, blocks) in enumerate(SWINL_STAGES):
        table = torch.randn((2 * WS - 1) ** 2, heads, generator=g, device=dev) * BIAS_TABLE_STD
        bias = table[idx].reshape(nt, nt, heads).permute(2, 0, 1).contiguous()
        scale, d, nw = (c // heads) ** -0.5, c // heads, (hp // WS) ** 2
        qkv32 = torch.randn(BATCH, hp, hp, 3 * c, generator=g, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = qkv32.to(dtype)
            for shift in (0, WS // 2):
                mask = torch.as_tensor(_attn_mask(h, h, hp, hp, WS, shift), device=dev)
                no_pad = _attn_mask(hp, hp, hp, hp, WS, shift)
                no_pad = None if no_pad is None else torch.as_tensor(no_pad, device=dev)
                args = (qkv, bias, mask, heads, WS, scale)
                out = WA_KERNEL(*args)
                what = (f"window attention Swin-Large/1280 [{BATCH},{hp},{hp},{3 * c}] "
                        f"shift={shift} {dtype}")
                err, excess = 0.0, 0.0
                for i in range(0, BATCH, PLAIN_SLICE):
                    part = (qkv[i:i + PLAIN_SLICE],) + args[1:]
                    ref = _wa.window_attention_plain(*part)
                    err = max(err, (out[i:i + PLAIN_SLICE].float() - ref.float()).abs()
                              .max().item())
                    excess = max(excess, wa_excess(out[i:i + PLAIN_SLICE], ref, dtype))
                    if i == 0:
                        ctrl = _wa.window_attention_plain(part[0], bias, no_pad, heads, WS,
                                                          scale)
                        ctrl_excess = wa_excess(ctrl, ref, dtype)
                        del ctrl
                    del ref
                if not math.isfinite(excess) or excess > 1.0:
                    fail(f"{what}: error {excess:.3f}x its tolerance {TOL_WA[dtype]} "
                         f"(max abs err {err})")
                if ctrl_excess <= 1.0:
                    fail(f"{what}: the control (pad sentinel removed) passes the check")
                max_err, max_excess = max(max_err, err), max(max_excess, excess)
                min_control = min(min_control, ctrl_excess)
                msg = (f"  window_attention Swin-Large/1280 [{BATCH},{hp},{hp},{3 * c}] "
                       f"H={heads} shift={shift} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                       f"err/tol={excess:.3f} (tol atol+rtol|ref| {TOL_WA[dtype]}, plain "
                       f"version in slices of {PLAIN_SLICE}) control (pad sentinel removed) "
                       f"err/tol={ctrl_excess:.1f}")
                del out
                if dtype == torch.bfloat16:
                    k_ms = time_ms(lambda: WA_KERNEL(*args), reps=5, samples=3)
                    nbytes = qkv.numel() * qkv.element_size() * 4 / 3 + bias.numel() * 4 + \
                        mask.numel() * 4
                    b_ms, kind = bound_ms(nbytes, 4.0 * BATCH * nw * heads * nt * nt * d, dtype)
                    # library yardstick, as in check_window_attention: SDPA on
                    # pre-partitioned q / k / v, bias + mask as a float mask
                    x = qkv.reshape(BATCH, hp // WS, WS, hp // WS, WS, 3, heads, d)
                    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7)
                    q, k, v = (x[j].reshape(BATCH, nw * heads, nt, d) for j in range(3))
                    am = (bias[None] + mask[:, None]).reshape(nw * heads, nt, nt).to(dtype)
                    l_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=am, scale=scale), reps=5, samples=3)
                    del x, q, k, v, am
                    msg += (f" kernel_ms={k_ms:.4f} library_ms(SDPA)={l_ms:.4f} "
                            f"bound_ms={b_ms:.4f} ({kind}) launches/forward={blocks // 2} "
                            f"({k_ms / b_ms:.2f}x its bound)")
                    if stage == 0:
                        stage0_ms[shift] = k_ms
                    total["ms"] += blocks // 2 * k_ms
                    total["bound_ms"] += blocks // 2 * b_ms
                    total["library_ms"] += blocks // 2 * l_ms
                log(msg)
                del args
            del qkv
        del qkv32
        torch.cuda.empty_cache()
    log(f"  padded window attention controls: smallest err/tol {min_control:.1f} (must be > 1)")
    log(f"  window_attention Swin-Large/1280 a forward at batch {BATCH}: "
        f"{sum(b for *_, b in SWINL_STAGES)} launches, {total['ms']:.3f} ms against a "
        f"{total['bound_ms']:.3f} ms bound ({total['ms'] / total['bound_ms']:.2f}x); "
        f"SDPA on the same inputs {total['library_ms']:.3f} ms")
    return {"max_abs_err": max_err, "err_over_tol": max_excess, "stage0_ms": stage0_ms,
            **total}


# the fused attention half at Swin-Base's stages 0 and 1, the blocks that
# fuse: (Hp = Wp, C, heads); block 0 of each stage is unshifted, block 1
# shifted (with a mask), one of each per forward
AH_STAGES = ((56, 128, 4), (28, 256, 8))


def attention_half_by_library(args: tuple, heads: int) -> torch.Tensor:
    """The same block as PyTorch's own calls: layer_norm, linear, SDPA over
    the partitioned windows with bias + mask as its float mask (partition and
    reverse copies included), linear, add.  A yardstick, never the port's."""
    x, ln_g, ln_b, wqkv, bqkv, wproj, bproj, bias, mask = args
    b, hp, wp, c = x.shape
    nw, nt, d = (hp // WS) * (wp // WS), WS * WS, c // heads
    xn = torch.nn.functional.layer_norm(x.float(), (c,), ln_g, ln_b, 1e-5).to(x.dtype)
    qkv = torch.nn.functional.linear(xn, wqkv, bqkv)
    qkv = qkv.reshape(b, hp // WS, WS, wp // WS, WS, 3, heads, d)
    qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nw, heads, nt, d)
    am = bias[None] + (mask[:, None] if mask is not None else 0.0)
    am = am.expand(b, nw, heads, nt, nt).reshape(b * nw, heads, nt, nt).to(x.dtype)
    o = torch.nn.functional.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=am,
                                                         scale=d ** -0.5)
    om = o.reshape(b, hp // WS, wp // WS, heads, WS, WS, d).permute(0, 1, 4, 2, 5, 3, 6)
    return x + torch.nn.functional.linear(om.reshape(b, hp, wp, c), wproj, bproj)


def attn_half_bound(args: tuple, heads: int, backward: bool) -> tuple[float, str]:
    """Least time for the block: x read and y written (backward: x, dy read,
    dx written), weights and tables once; operations 2 M C 4C + 4 M T C
    forward, 22 M C^2 + 12 M T C backward (qkv and the attention recomputed,
    then dom, the attention's four products, dwproj, dwqkv and dxn)."""
    x, bias, mask = args[0], args[7], args[8]
    m, c, nt = x.numel() // x.shape[-1], x.shape[-1], WS * WS
    es = x.element_size()
    params = (4 * c * c + 4 * c) * es + 2 * c * 4 + bias.numel() * 4 + (
        mask.numel() * 4 if mask is not None else 0)
    if backward:
        return bound_ms(3 * x.numel() * es + 2 * params, 22.0 * m * c * c + 12.0 * m * nt * c,
                        x.dtype)
    return bound_ms(2 * x.numel() * es + params, 8.0 * m * c * c + 4.0 * m * nt * c, x.dtype)


def check_attn_half(g: torch.Generator) -> dict:
    """Kernel 4 at the serving calls: [64, 56, 56, 128] with 4 heads and
    [64, 28, 28, 256] with 8, unshifted and shifted, bf16 and fp32."""
    per_forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                   "unfused_ms": 0.0}
    max_err, min_control = 0.0, math.inf
    bound_kinds = {"bytes": 0.0, "operations": 0.0}
    for hp, c, heads in AH_STAGES:
        for shifted in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                atol, rtol = TOL_AH[dtype]
                args = attn_half_inputs(g, BATCH, hp, c, heads, shifted, dtype)
                out = AH_KERNEL(*args, heads, WS)
                ref = _ah.attn_half_plain(*args, heads, WS)
                torch.cuda.synchronize()
                what = f"attention half {hp}x{hp} C={c} shift={shifted} {dtype}"
                err = (out.float() - ref.float()).abs().max().item()
                excess = close_excess(out, ref, atol, rtol)
                if not math.isfinite(excess) or excess > 1.0:
                    fail(f"{what}: error {excess:.3f}x its tolerance {TOL_AH[dtype]} "
                         f"(max abs err {err})")
                max_err = max(max_err, err)
                # controls: the bias omitted, and the residual dropped
                no_bias = args[:7] + (torch.zeros_like(args[7]), args[8])
                controls = (_ah.attn_half_plain(*no_bias, heads, WS),
                            (ref.float() - args[0].float()).to(dtype))
                ctrl_excess = min(close_excess(ctrl, ref, atol, rtol) for ctrl in controls)
                if ctrl_excess <= 1.0:
                    fail(f"{what}: a control (bias omitted, residual dropped) passes the check")
                min_control = min(min_control, ctrl_excess)
                del controls, no_bias, out, ref
                what_log = (f"  attn_half [{BATCH},{hp},{hp},{c}] H={heads} shift={int(shifted)} "
                            f"{str(dtype)[6:]}: max_abs_err={err:.3e} err/tol={excess:.3f} (tol "
                            f"atol+rtol|ref| {TOL_AH[dtype]}) control err/tol>={ctrl_excess:.1f}")
                if dtype != torch.bfloat16:  # timed in the serving path's dtype only
                    log(what_log)
                    del args
                    continue
                k_ms = time_ms(lambda: AH_KERNEL(*args, heads, WS), reps=20, samples=3)
                p_ms = time_ms(lambda: _ah.attn_half_plain(*args, heads, WS), reps=3, samples=3)
                l_ms = time_ms(lambda: attention_half_by_library(args, heads), reps=5, samples=3)
                u_ms = time_ms(lambda: attention_half_unfused(args, heads), reps=5, samples=3)
                b_ms, kind = attn_half_bound(args, heads, backward=False)
                log(f"{what_log} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms(LN+linear+"
                    f"SDPA+linear)={l_ms:.4f} unfused_ms(LN+linear+kernel 1+linear)={u_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({kind})")
                for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                                 ("unfused_ms", u_ms), ("bound_ms", b_ms)):
                    per_forward[key] += val  # one block of each per forward
                bound_kinds[kind] += b_ms
                del args
                torch.cuda.empty_cache()
    log(f"  attention half controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return {"max_abs_err": max_err, "bound_by": max(bound_kinds, key=bound_kinds.get),
            **per_forward}


def first_chunk_qkv_gradient(args: tuple, dy: torch.Tensor, heads: int) -> torch.Tensor:
    """The first token chunk's share of dwqkv = dqkv^T xn, as the backward's
    weight-gradient kernel sums it into one partial, in plain PyTorch (xn,
    qkv, do and dqkv rounded as in the kernels)."""
    x, ln_g, ln_b, wqkv, bqkv, wproj, _, bias, mask = args
    b, hp, wp, c = x.shape
    m, dt = b * hp * wp, x.dtype
    geo = _ah.bwd_geometry(b, m, c, (hp // WS) * (wp // WS), heads, dt)
    chunk = -(-m // 64 // geo["w_chunks"]) * 64
    xn = torch.nn.functional.layer_norm(x.float(), (c,), ln_g, ln_b, 1e-5).to(dt)
    qkv = (xn.float() @ wqkv.float().T + bqkv.float()).to(dt)
    dom = (dy.float() @ wproj.float()).to(dt)
    dqkv, _ = _wa.window_attention_bwd_plain(qkv, bias, mask, dom, heads, WS,
                                             (c // heads) ** -0.5)
    return dqkv.reshape(m, 3 * c)[:chunk].float().T @ xn.reshape(m, c)[:chunk].float()


AH_GRAD_NAMES = ("dx", "dln_g", "dln_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")


def check_attn_half_bwd(g: torch.Generator) -> dict:
    """Kernel 4b at the training calls (batch 128): dx per element, every
    parameter gradient within a fraction of its own largest entry; two runs
    bit for bit.  Also holds the forward kernel at that batch, the training
    forward's own launches, as check_attn_half holds it at batch 64, and
    times it beside the unfused route's forward."""
    per_step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "unfused_ms": 0.0, "fwd_ms": 0.0, "fwd_unfused_ms": 0.0}
    max_err, worst, min_control = 0.0, 0.0, math.inf
    fwd_err, fwd_min_control = 0.0, math.inf
    bound_kinds = {"bytes": 0.0, "operations": 0.0}
    batch = TRAIN_VIEWS
    for hp, c, heads in AH_STAGES:
        for shifted in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                atol, rtol, gtol = TOL_AH_BWD[dtype]
                args = attn_half_inputs(g, batch, hp, c, heads, shifted, dtype)
                dy = torch.randn(args[0].shape, generator=g, device="cuda").to(dtype)
                # the forward's launch at this batch, held as at batch 64
                f_atol, f_rtol = TOL_AH[dtype]
                out = AH_KERNEL(*args, heads, WS)
                ref = _ah.attn_half_plain(*args, heads, WS)
                torch.cuda.synchronize()
                what = f"attention half {hp}x{hp} C={c} shift={shifted} {dtype} batch {batch}"
                f_excess = close_excess(out, ref, f_atol, f_rtol)
                if not math.isfinite(f_excess) or f_excess > 1.0:
                    fail(f"{what}: error {f_excess:.3f}x its tolerance {TOL_AH[dtype]} (max abs "
                         f"err {(out.float() - ref.float()).abs().max().item()})")
                no_bias = args[:7] + (torch.zeros_like(args[7]), args[8])
                f_ctrl = min(close_excess(_ah.attn_half_plain(*no_bias, heads, WS), ref, f_atol,
                                          f_rtol),
                             close_excess((ref.float() - args[0].float()).to(dtype), ref, f_atol,
                                          f_rtol))
                if f_ctrl <= 1.0:
                    fail(f"{what}: a control (bias omitted, residual dropped) passes the check")
                fwd_err = max(fwd_err, (out.float() - ref.float()).abs().max().item())
                fwd_min_control = min(fwd_min_control, f_ctrl)
                log(f"  attn_half [{batch},{hp},{hp},{c}] H={heads} shift={int(shifted)} "
                    f"{str(dtype)[6:]}: err/tol={f_excess:.3f} (tol atol+rtol|ref| "
                    f"{TOL_AH[dtype]}) control err/tol>={f_ctrl:.1f}")
                del out, ref, no_bias

                got = AH_BWD_KERNEL(*args, dy, heads, WS)
                ref = _ah.attn_half_bwd_plain(*args, dy, heads, WS)
                again = AH_BWD_KERNEL(*args, dy, heads, WS)
                torch.cuda.synchronize()
                what = f"attention half backward {hp}x{hp} C={c} shift={shifted} {dtype}"
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{what}: two runs of the backward kernel differ")
                del again
                err = (got[0].float() - ref[0].float()).abs().max().item()
                excess = close_excess(got[0], ref[0], atol, rtol)
                if not math.isfinite(excess) or excess > 1.0:
                    fail(f"{what}: dx error {excess:.3f}x its tolerance (max abs err {err})")
                rels = {}
                for name, a, r in zip(AH_GRAD_NAMES[1:], got[1:], ref[1:]):
                    rels[name] = (a - r).abs().max().item() / r.abs().max().item()
                    if not math.isfinite(rels[name]) or rels[name] > gtol:
                        fail(f"{what}: {name} off by {rels[name]:.3e} of its largest entry "
                             f"(tol {gtol})")
                max_err = max(max_err, err)
                worst = max(worst, excess, max(rels.values()) / gtol)
                # controls: one chunk's dwqkv partial dropped (the share of
                # the first chunk of tokens taken away), and dbias dropped
                share = first_chunk_qkv_gradient(args, dy, heads)
                ctrl_w = share.abs().max().item() / ref[3].abs().max().item()
                ctrl = min(ctrl_w, 1.0) / gtol  # dbias dropped: |0 - ref| is 1.0 of its max
                if ctrl <= 1.0:
                    fail(f"{what}: a control (one chunk's dwqkv dropped, dbias dropped) passes "
                         f"the check")
                min_control = min(min_control, ctrl)
                del got, ref, share
                what_log = (f"  attn_half_bwd [{batch},{hp},{hp},{c}] H={heads} shift="
                            f"{int(shifted)} {str(dtype)[6:]}: dx max_abs_err={err:.3e} err/tol="
                            f"{excess:.3f} (tol {atol}+{rtol:.4f}|ref|) gradients off by (of their "
                            f"largest entry) {', '.join(f'{k} {v:.2e}' for k, v in rels.items())} "
                            f"(tol {gtol}); two runs equal; control err/tol>={ctrl:.1f} (one "
                            f"chunk's dwqkv {ctrl_w:.3e})")
                if dtype != torch.bfloat16:  # timed in the training path's dtype only
                    log(what_log)
                    del args, dy
                    continue
                k_ms = time_ms(lambda: AH_BWD_KERNEL(*args, dy, heads, WS), reps=5, samples=3)
                p_ms = time_ms(lambda: _ah.attn_half_bwd_plain(*args, dy, heads, WS), reps=2,
                               samples=3)
                f_ms = time_ms(lambda: AH_KERNEL(*args, heads, WS), reps=5, samples=3)
                fu_ms = time_ms(lambda: attention_half_unfused(args, heads), reps=5, samples=3)
                grads_of = {}
                for route, fn in (("library", attention_half_by_library),
                                  ("unfused", attention_half_unfused)):
                    leaves = [t.detach().clone().requires_grad_() for t in args[:8]]
                    y = fn((*leaves, args[8]), heads)
                    grads_of[route] = time_ms(
                        lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True), reps=3,
                        samples=3)
                    del leaves, y
                b_ms, kind = attn_half_bound(args, heads, backward=True)
                split = launch_split(lambda: AH_BWD_KERNEL(*args, dy, heads, WS))
                log(f"{what_log} launches a call: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
                log(f"{what_log} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms(autograd of "
                    f"LN+linear+SDPA+linear)={grads_of['library']:.4f} unfused_ms(autograd of "
                    f"LN+linear+kernel 1b+linear)={grads_of['unfused']:.4f} bound_ms={b_ms:.4f} "
                    f"({kind}) fwd_kernel_ms={f_ms:.4f} fwd_unfused_ms(LN+linear+kernel 1+"
                    f"linear)={fu_ms:.4f} scratch "
                    f"{sum(_ah.scratch_bytes(args[0], heads, WS).values()) / 1e6:.1f} MB")
                for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                                 ("library_ms", grads_of["library"]),
                                 ("unfused_ms", grads_of["unfused"]), ("bound_ms", b_ms),
                                 ("fwd_ms", f_ms), ("fwd_unfused_ms", fu_ms)):
                    per_step[key] += val  # one block of each per train step
                bound_kinds[kind] += b_ms
                del args, dy
                torch.cuda.empty_cache()
    log(f"  attention half backward controls: smallest err/tol {min_control:.1f} (must be > 1)")
    log(f"  attention half forward at batch {batch}: max_abs_err={fwd_err:.3e}, controls' "
        f"smallest err/tol {fwd_min_control:.1f} (must be > 1)")
    return {"max_abs_err": max_err, "err_over_tol": worst, "fwd_max_abs_err": fwd_err,
            "bound_by": max(bound_kinds, key=bound_kinds.get), **per_step}


# ----------------------------------------------------------------------------
# phase 3: serving end to end
# ----------------------------------------------------------------------------


def zero_launches(**counts) -> dict:
    return {**{name: 0 for name in KERNELS}, **counts}


# the two model families the port serves and trains: configuration, launches
# per serving forward and per train step, and the controls their checks reject
SWIN = {
    "label": "Swin-Base/224", "config": FLAGSHIP, "profile_prefix": "",
    "serve_launches": zero_launches(window_attention_fwd=24, gpf_fwd=1),
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
    "serve_launches": zero_launches(packed_attention_fwd=VIT_DEPTH, gpf_fwd=1),
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
                                    gpf_fwd=1),
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
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL_LOGITS_REL[torch.bfloat16]
    log(f"  bf16 logits (batch {nb}) kernel vs plain: max_abs_err={err:.4e} "
        f"({err / scale:.4e} of max |logit| {scale:.4e}); tol {tol} x max")
    if err > tol * scale:
        fail("bf16 serving logits disagree with the plain path")
    controls = [(family["serve_control"], family["serve_control_name"]),
                *family.get("extra_serve_controls", [])]
    for control, name in controls:
        with control(model):
            ctrl = infer(sub)
        torch.cuda.synchronize()
        err_ctrl = (ctrl.float() - ref.float()).abs().max().item()
        log(f"  control ({name}): {err_ctrl:.4e} ({err_ctrl / scale:.4e} of max |logit|)")
        if err_ctrl <= tol * scale:
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
            "vs_default": vs_default, "turns": turns}


# ----------------------------------------------------------------------------
# phase 4: training end to end
# ----------------------------------------------------------------------------


def step_gradients(model, anchor, positive, labels) -> dict:
    """One forward + backward on fixed views, dropout off: {leaf: gradient}."""
    model.eval()  # dropout off; gradients still flow
    model.zero_grad(set_to_none=True)
    model(anchor, positive, labels)["loss"].backward()
    torch.cuda.synchronize()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def worst_leaf(grads: dict, ref: dict, dtype, ill: dict) -> tuple[float, str, float]:
    """Over the leaves, the largest ||g - g_ref|| / ||g_ref|| as a multiple of
    the leaf's tolerance (``ill`` for the ill-conditioned leaves), with the
    leaf and its relative error."""
    worst, where, worst_rel = 0.0, "", 0.0
    for name, r in ref.items():
        r32 = r.float()
        denom = r32.norm().item()
        rel = (grads[name].float() - r32).norm().item() / max(denom, 1e-30)
        if not math.isfinite(rel):
            return math.inf, name, math.inf
        tol = ill.get(name, {}).get(dtype, TOL_GRADS_REL[dtype])
        if rel / tol > worst:
            worst, where, worst_rel = rel / tol, name, rel
    return worst, where, worst_rel


def check_gradients(model, anchor, positive, labels, dtype, what: str, family: dict) -> float:
    grads = step_gradients(model, anchor, positive, labels)
    with plain_kernels():
        ref = step_gradients(model, anchor, positive, labels)
    with family["grad_control"]():
        ctrl = step_gradients(model, anchor, positive, labels)
    tol = TOL_GRADS_REL[dtype]
    ill = family["ill_conditioned"]
    worst, where, rel = worst_leaf(grads, ref, dtype, ill)
    worst_ctrl, where_ctrl, rel_ctrl = worst_leaf(ctrl, ref, dtype, ill)
    _, where_well, rel_well = worst_leaf(grads, {k: v for k, v in ref.items() if k not in ill},
                                         dtype, {})
    log(f"  {what} gradients kernel vs plain, {len(ref)} leaves: worst err/tol {worst:.4f} "
        f"(relative error {rel:.4e}) at {where}, among the well-conditioned leaves "
        f"{rel_well:.4e} at {where_well}; control ({family['grad_control_name']}) err/tol "
        f"{worst_ctrl:.2f} (relative error {rel_ctrl:.4e}) at {where_ctrl}; tol {tol} per leaf, "
        f"{ill} apart")
    if worst > 1.0:
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
    n_timed = 5
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
    if not (eval_launches["window_attention_fwd"] and eval_launches["gpf_fwd"]):
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

    # the Hopper kernels run on wgmma: their SASS holds HGMMA (the bf16
    # attention 3, 6, 3b, 6b; 2b's bf16 w and dX kernels; the GEMM of 5′ and
    # 5″; 1b's window-attention core; 4b's qkv / do, dx and weight-gradient
    # products; the bf16 forwards of 1, 2 and 4)
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).parent / "cuobjdump")
    for name in ("packed_attention_fwd", "flash_attention_fwd", "packed_attention_bwd",
                 "flash_attention_bwd", "gpf_bwd", "newton_schulz_bf16",
                 "newton_schulz_bf16_streamed", "window_attention_bwd", "attn_half_fwd",
                 "attn_half_bwd", "window_attention_fwd", "gpf_fwd"):
        if not os.path.exists(cuobjdump):
            log(f"  {name}: cuobjdump not found, SASS not read")
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])], capture_output=True,
                              text=True, check=True).stdout
        n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
        log(f"  {name}: {n_hgmma} HGMMA instructions in its SASS (cuobjdump -sass)")
        if n_hgmma == 0:
            fail(f"{name} holds no wgmma (HGMMA) instruction")

    phase("[2] kernels against their plain versions, batch 64")
    g = torch.Generator(device="cuda").manual_seed(1234)
    with torch.inference_mode():
        wa = check_window_attention(g)
        pa = check_packed_attention(g)
        gp = check_gpf(g, 49, 1024)
        gp_vit = check_gpf(g, VIT_T - 1, VIT_C)
        gp_448 = check_gpf(g, VIT448_T - 1, VIT_C)
        gp_vitl = check_gpf(g, VITL_T - 1, VITL_C)
        gp_swinl = check_gpf(g, SWINL_N, SWINL_C)
        fa = check_flash_attention(g)
        fa_vitl = check_flash_attention(g, VITL_T, VITL_C, VITL_H, VITL_DEPTH)
        ns = check_newton_schulz(g)
        ns_wide = check_newton_schulz_bf16(g)
        wa_pad = check_window_attention_padded(g)
        ah = check_attn_half(g)

    phase(f"[2b] backward kernels against their plain versions, batch {TRAIN_VIEWS} / {BATCH}")
    wab = check_window_attention_bwd(g)
    pab = check_packed_attention_bwd(g)
    gpb = check_gpf_bwd(g, 49, 1024)
    gpb_vit = check_gpf_bwd(g, VIT_T - 1, VIT_C)
    gpb_448 = check_gpf_bwd(g, VIT448_T - 1, VIT_C)
    gpb_vitl = check_gpf_bwd(g, VITL_T - 1, VITL_C)
    gpb_swinl = check_gpf_bwd(g, SWINL_N, SWINL_C)
    fab = check_flash_attention_bwd(g)
    fab_vitl = check_flash_attention_bwd(g, VITL_T, VITL_C, VITL_H, VITL_DEPTH, plain_batch=16)
    occ_fwd = _fa.fwd_occupancy()
    log(f"  attention forward (3, 6) at d = 64: {occ_fwd['registers']} registers a thread, "
        f"{occ_fwd['blocks_per_sm']} blocks an SM; {occ_fwd['smem']} bytes of shared memory a "
        "block")
    occ = _fa.bwd_occupancy()
    log(f"  attention backward (3b, 6b) at d = 64: dq kernel {occ['dq_registers']} registers a "
        f"thread, {occ['dq_blocks_per_sm']} blocks an SM; dk/dv kernel {occ['dkv_registers']}, "
        f"{occ['dkv_blocks_per_sm']}; {occ['smem']} bytes of shared memory a block")
    ahb = check_attn_half_bwd(g)
    ns_bwd_ms = time_newton_schulz_bwd(g)
    torch.cuda.empty_cache()

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

    phase(f"[6] data pipeline, trainer, evaluator and checkpoints, Swin-Base/224 flagship, batch "
          f"{BATCH}, synthetic 80 x 8 images a split")
    eng = engine(card)

    # ms, plain_ms, bound_ms, library_ms: bf16, summed over one forward's
    # launches at batch 64 (forward kernels, the serving path) or over one
    # train step's launches at batch 128 / [64,N,D] x2 (backward kernels);
    # train_ms is a forward kernel's sum over one train step's launches.
    # launches: the count from the main path that runs the kernel (Swin-Base
    # for window attention, ViT-Base/224 for packed attention and for GPF, whose
    # Swin-path, 448-path and this slice's numbers ride along under swin_*,
    # vit448_*, vitL512_* and swinL1280_*, ViT-Base/448 for q-tiled attention
    # (ViT-Large/512 under vitL512_*) and for the fp32 Newton-Schulz,
    # ViT-Large/512 for the bf16 Newton-Schulz, Swin-Large/1280 for the
    # streamed one, Swin-Base under fused_half for the fused attention half,
    # whose unfused_ms is the port's default route for the same blocks); every
    # path was driven with the counts at 0 just before and read just after.
    src = "ego_moment_cle_vit_tpu_torch/csrc/"

    def other_gpf(prefix: str, res: dict) -> dict:
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "launch_ms",
                "full_gram_bound_ms")
        return {f"{prefix}_{k}": res[k] for k in keys if k in res}

    def ns_row(name: str, variant: str, source: str, replaces: str, launches: int) -> dict:
        res = ns_wide[variant]
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches, **{k: res[k] for k in (
                    "max_abs_err", "err_over_tol", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "tflops", "library_tflops")}}

    kernels = [
        {"name": "window_attention_fwd", "route": "cuda",
         "source": src + "window_attention_fwd.cu",
         "replaces": WA_REPLACES, "launches": srv["launches"]["window_attention_fwd"],
         "train_launches": trn["launches"]["window_attention_fwd"],
         "max_abs_err": wa["max_abs_err"], "ms": wa["ms"], "plain_ms": wa["plain_ms"],
         "bound_ms": wa["bound_ms"], "bound_by": wa["bound_by"],
         "library_ms": wa["library_ms"], "train_ms": wab["fwd_ms"],
         "swinL1280_launches": srv_swinl["launches"]["window_attention_fwd"],
         "swinL1280_padded_max_abs_err": wa_pad["max_abs_err"],
         "swinL1280_padded_err_over_tol": wa_pad["err_over_tol"],
         "swinL1280_stage0_padded_ms_b64": wa_pad["stage0_ms"],
         "swinL1280_forward_ms_b64": wa_pad["ms"],
         "swinL1280_forward_bound_ms_b64": wa_pad["bound_ms"],
         "swinL1280_forward_library_ms_b64": wa_pad["library_ms"],
         "engine_step_launches": eng["step_launches"]["window_attention_fwd"],
         "engine_eval_launches": eng["eval_launches"]["window_attention_fwd"]},
        {"name": "window_attention_bwd", "route": "cuda",
         "source": src + "window_attention_bwd.cu",
         "replaces": WA_BWD_REPLACES, "launches": trn["launches"]["window_attention_bwd"],
         "max_abs_err": wab["max_abs_err"], "err_over_tol": wab["err_over_tol"],
         "ms": wab["ms"], "plain_ms": wab["plain_ms"], "bound_ms": wab["bound_ms"],
         "bound_by": wab["bound_by"], "library_ms": wab["library_ms"],
         "library_no_dbias_ms": wab["library_no_dbias_ms"],
         "engine_step_launches": eng["step_launches"]["window_attention_bwd"]},
        {"name": "gpf_fwd", "route": "cuda", "source": src + "gpf_fwd.cu",
         "replaces": GPF_REPLACES, "launches": srv_vit["launches"]["gpf_fwd"],
         "train_launches": trn_vit["launches"]["gpf_fwd"],
         "swin_launches": srv["launches"]["gpf_fwd"],
         "max_abs_err": gp_vit["max_abs_err"],
         "err_over_tol": max(gp["err_over_tol"], gp_vit["err_over_tol"], gp_448["err_over_tol"]),
         "ms": gp_vit["ms"], "plain_ms": gp_vit["plain_ms"],
         "bound_ms": gp_vit["bound_ms"], "bound_by": gp_vit["bound_by"],
         "full_gram_bound_ms": gp_vit["full_gram_bound_ms"],
         "library_ms": gp_vit["library_ms"], "train_ms": gpb_vit["fwd_ms"],
         **other_gpf("swin", gp), "swin_train_ms": gpb["fwd_ms"],
         **other_gpf("vit448", gp_448), "vit448_train_ms": gpb_448["fwd_ms"],
         **other_gpf("vitL512", gp_vitl), "vitL512_launches": srv_vitl["launches"]["gpf_fwd"],
         "vitL512_train_ms": gpb_vitl["fwd_ms"],
         **other_gpf("swinL1280", gp_swinl),
         "swinL1280_launches": srv_swinl["launches"]["gpf_fwd"],
         "engine_step_launches": eng["step_launches"]["gpf_fwd"],
         "engine_eval_launches": eng["eval_launches"]["gpf_fwd"]},
        {"name": "gpf_bwd", "route": "cuda", "source": src + "gpf_bwd.cu",
         "replaces": GPF_BWD_REPLACES, "launches": trn_vit["launches"]["gpf_bwd"],
         "swin_launches": trn["launches"]["gpf_bwd"],
         "max_abs_err": gpb_vit["max_abs_err"],
         "err_over_tol": max(gpb["err_over_tol"], gpb_vit["err_over_tol"],
                             gpb_448["err_over_tol"], gpb_vitl["err_over_tol"],
                             gpb_swinl["err_over_tol"]),
         "ms": gpb_vit["ms"], "plain_ms": gpb_vit["plain_ms"], "bound_ms": gpb_vit["bound_ms"],
         "bound_by": gpb_vit["bound_by"], "library_ms": gpb_vit["library_ms"],
         "launch_ms": gpb_vit["launch_ms"],
         **other_gpf("swin", gpb), **other_gpf("vit448", gpb_448),
         **other_gpf("vitL512", gpb_vitl), "vitL512_launches": trn_vitl["launches"]["gpf_bwd"],
         **other_gpf("swinL1280", gpb_swinl),
         "engine_step_launches": eng["step_launches"]["gpf_bwd"]},
        {"name": "packed_attention_fwd", "route": "cuda",
         "source": src + "packed_attention_fwd.cu",
         "replaces": PA_REPLACES, "launches": srv_vit["launches"]["packed_attention_fwd"],
         "train_launches": trn_vit["launches"]["packed_attention_fwd"],
         "max_abs_err": pa["max_abs_err"], "ms": pa["ms"], "plain_ms": pa["plain_ms"],
         "bound_ms": pa["bound_ms"], "bound_by": pa["bound_by"],
         "library_ms": pa["library_ms"], "train_ms": pab["fwd_ms"],
         "train_library_ms": pab["fwd_library_ms"], "gb_per_s": pa["gb_per_s"],
         "library_gb_per_s": pa["library_gb_per_s"], "occupancy": occ_fwd},
        {"name": "packed_attention_bwd", "route": "cuda",
         "source": src + "packed_attention_bwd.cu",
         "replaces": PA_BWD_REPLACES, "launches": trn_vit["launches"]["packed_attention_bwd"],
         "max_abs_err": pab["max_abs_err"], "err_over_tol": pab["err_over_tol"],
         "ms": pab["ms"], "plain_ms": pab["plain_ms"], "bound_ms": pab["bound_ms"],
         "bound_by": pab["bound_by"], "library_ms": pab["library_ms"]},
        {"name": "flash_attention_tiled_fwd", "route": "cuda",
         "source": src + "flash_attention_fwd.cu",
         "replaces": FA_REPLACES, "launches": srv_448["launches"]["flash_attention_tiled_fwd"],
         "train_launches": trn_448["launches"]["flash_attention_tiled_fwd"],
         "max_abs_err": fa["max_abs_err"], "ms": fa["ms"], "plain_ms": fa["plain_ms"],
         "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
         "library_ms": fa["library_ms"], "train_ms": fab["fwd_ms"],
         "train_library_ms": fab["fwd_library_ms"], "tflops": fa["tflops"],
         "library_tflops": fa["library_tflops"], "occupancy": occ_fwd,
         **other_gpf("vitL512", fa_vitl), "vitL512_train_ms": fab_vitl["fwd_ms"],
         "vitL512_train_library_ms": fab_vitl["fwd_library_ms"],
         "vitL512_tflops": fa_vitl["tflops"],
         "vitL512_launches": srv_vitl["launches"]["flash_attention_tiled_fwd"],
         "vitL512_train_launches": trn_vitl["launches"]["flash_attention_tiled_fwd"]},
        {"name": "flash_attention_tiled_bwd", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": FA_BWD_REPLACES,
         "launches": trn_448["launches"]["flash_attention_tiled_bwd"],
         "max_abs_err": fab["max_abs_err"], "err_over_tol": fab["err_over_tol"],
         "ms": fab["ms"], "plain_ms": fab["plain_ms"], "bound_ms": fab["bound_ms"],
         "bound_by": fab["bound_by"], "library_ms": fab["library_ms"],
         "vitL512_launches": trn_vitl["launches"]["flash_attention_tiled_bwd"],
         "vitL512_max_abs_err": fab_vitl["max_abs_err"], "vitL512_ms": fab_vitl["ms"],
         "vitL512_plain_ms_b16": fab_vitl["plain_ms"], "vitL512_bound_ms": fab_vitl["bound_ms"],
         "vitL512_library_ms": fab_vitl["library_ms"], "occupancy": occ},
        {"name": "newton_schulz_isqrt_fp32_fwd", "route": "cuda",
         "source": src + "newton_schulz.cu", "replaces": NS_REPLACES,
         "launches": srv_448["launches"]["newton_schulz_isqrt_fp32_fwd"],
         "train_launches": trn_448["launches"]["newton_schulz_isqrt_fp32_fwd"],
         "max_abs_err": ns["max_abs_err"], "ms": ns["ms"], "plain_ms": ns["plain_ms"],
         "bound_ms": ns["bound_ms"], "bound_by": ns["bound_by"],
         "library_ms": ns["library_ms"]},
        {**ns_row("newton_schulz_isqrt_bf16_fwd", "bf16", "newton_schulz_bf16.cu",
                  NS_BF16_REPLACES, srv_vitl["launches"]["newton_schulz_isqrt_bf16_fwd"]),
         "train_launches": trn_vitl["launches"]["newton_schulz_isqrt_bf16_fwd"],
         "backward_plain_ms": ns_bwd_ms},
        ns_row("newton_schulz_isqrt_bf16_streamed_fwd", "bf16_streamed",
               "newton_schulz_bf16_streamed.cu", NS_BF16S_REPLACES,
               srv_swinl["launches"]["newton_schulz_isqrt_bf16_streamed_fwd"]),
        {"name": "attn_half_fwd", "route": "cuda", "source": src + "attn_half_fwd.cu",
         "replaces": AH_REPLACES, "launches": srv_fh["launches"]["attn_half_fwd"],
         "train_launches": trn_fh["launches"]["attn_half_fwd"],
         "max_abs_err": ah["max_abs_err"], "ms": ah["ms"], "plain_ms": ah["plain_ms"],
         "bound_ms": ah["bound_ms"], "bound_by": ah["bound_by"],
         "library_ms": ah["library_ms"], "unfused_ms": ah["unfused_ms"],
         "train_ms": ahb["fwd_ms"], "train_unfused_ms": ahb["fwd_unfused_ms"],
         "train_max_abs_err": ahb["fwd_max_abs_err"]},
        {"name": "attn_half_bwd", "route": "cuda", "source": src + "attn_half_bwd.cu",
         "replaces": AH_BWD_REPLACES, "launches": trn_fh["launches"]["attn_half_bwd"],
         "max_abs_err": ahb["max_abs_err"], "err_over_tol": ahb["err_over_tol"],
         "ms": ahb["ms"], "plain_ms": ahb["plain_ms"], "bound_ms": ahb["bound_ms"],
         "bound_by": ahb["bound_by"], "library_ms": ahb["library_ms"],
         "unfused_ms": ahb["unfused_ms"]},
    ]
    for entry in kernels:
        if entry["launches"] < 1:
            fail(f"kernel {entry['name']} was launched no time on its main path")
    if len(kernels) != len(KERNELS):
        fail(f"the kernels line lists {len(kernels)} kernels, the port has {len(KERNELS)}")
    for label, s_res, t_res in (("Swin-Base/224", srv, trn),
                                ("Swin-Base/224 fused_half", srv_fh, trn_fh),
                                ("ViT-Base/224", srv_vit, trn_vit),
                                ("ViT-Base/448", srv_448, trn_448),
                                ("ViT-Large/512", srv_vitl, trn_vitl),
                                ("Swin-Large/1280", srv_swinl, None)):
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
    log(f"  total {time.time() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
