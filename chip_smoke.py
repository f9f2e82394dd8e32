#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py                 # what the check runs: one card
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table

Phases (any failed check exits non-zero; no phase catches and continues):

1. Setup: card name and power limit, kernel build from ``csrc/`` (seconds).
2. Kernels against their plain PyTorch versions on the card at the serving
   path's shapes for batch 64: window attention at the four Swin-Base stage
   geometries (shifted and unshifted, bf16 and fp32) and fused GPF at
   [64, 49, 1024] (dot and cosine, bf16 and fp32), with errors, kernel /
   plain / library times from CUDA events and the bytes-or-operations bound.
   Each check is run on a control too (bias or mask dropped, off-diagonal
   GPF entries zeroed), which it must reject.
3. Serving end to end: the flagship configuration (Swin-Base/224 bf16, GPF
   2x2 dot, moment d_out 1024 with the FFT sketch, bf16 vech projection,
   'add' classifier, 80 classes) with seeded random weights, uint8
   [64, 256, 256, 3] through ``make_infer_fn``.  Checks finite [64, 80]
   logits, 24 window-attention launches and 1 GPF launch per forward, and the
   logits against the same model with every kernel swapped for its plain
   version (bf16 at batch 64, fp32 at batch 8), and rejects the kernel run
   with its bias omitted.  Relative-position tables are drawn at std 1, as
   trained ones reach, so the bias matters.  Prints images/s and peak memory.
4. A JSON line of the kernels, then the contract's last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from ego_moment_cle_vit_tpu_torch import create_model, make_infer_fn
from ego_moment_cle_vit_tpu_torch.data import AugmentConfig
from ego_moment_cle_vit_tpu_torch.kernels import _build
from ego_moment_cle_vit_tpu_torch.kernels import gpf as _gpf
from ego_moment_cle_vit_tpu_torch.kernels import window_attention as _wa
from ego_moment_cle_vit_tpu_torch.models.swin import _attn_mask, _relative_position_index

BATCH = 64
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
}
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
BIAS_TABLE_STD = 1.0  # trained Swin tables reach this; at init (0.02) the bias is invisible

WA_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/window_attention.py:361"
GPF_REPLACES = "ego_moment_cle_vit_tpu/ops/pallas/gpf.py:41"
WA_KERNEL = _wa.window_attention_fwd
GPF_KERNEL = _gpf.gpf_fwd


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
    """Swap every kernel wrapper the model calls for its plain version."""
    saved = (_wa.window_attention_fwd, _gpf.gpf_fwd)
    _wa.window_attention_fwd = _wa.window_attention_plain
    _gpf.gpf_fwd = _gpf.gpf_plain
    try:
        yield
    finally:
        _wa.window_attention_fwd, _gpf.gpf_fwd = saved


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
    bound_kinds = set()
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
                    bound_kinds.add(kind)
                del qkv, out, ref, q, k, v, am
    torch.cuda.empty_cache()
    log(f"  window attention controls: smallest err/tol {min_control:.1f} (must be > 1)")
    return {"max_abs_err": max_err, "bound_by": "/".join(sorted(bound_kinds)), **per_forward}


def check_gpf(g: torch.Generator) -> dict:
    dev = torch.device("cuda")
    n, d = 49, 1024
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
                flops = n_in * 2.0 * BATCH * n * n * d
                b_ms, kind = bound_ms(nbytes, flops, dtype)
                log(f"  gpf [{BATCH},{n},{d}] {sim} same_tokens={int(same)} {str(dtype)[6:]}: "
                    f"max_abs_err={err:.3e} err/tol={excess:.4f} (tol {TOL_GPF} x "
                    f"gpf_error_scale) control err/tol={ctrl_excess:.3e} kernel_ms={k_ms:.4f} "
                    f"plain_ms={p_ms:.4f} library_ms(bmm Gram)={l_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({kind})")
                if dtype == torch.bfloat16 and sim == "dot" and same:  # the serving call
                    main = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": kind}
    # max_abs_err is the serving call's, in its own units (dot Grams of
    # unit-variance tokens reach ~1e12 on the diagonal after the degree-4
    # terms); err_over_tol is the worst over every check
    return {"err_over_tol": worst, **main}


# ----------------------------------------------------------------------------
# phase 3: serving end to end
# ----------------------------------------------------------------------------


def serve(card: str, profile_dir: str | None) -> dict:
    dev = torch.device("cuda")
    aug = AugmentConfig(input_size=224, resize_size=256)
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.randint(0, 256, (BATCH, 256, 256, 3), generator=g, device=dev,
                           dtype=torch.uint8)

    t0 = time.time()
    model = create_model(FLAGSHIP, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model, g)
    infer = make_infer_fn(model, aug)
    logits = infer(images)
    torch.cuda.synchronize()
    log(f"  model built and first forward in {time.time() - t0:.1f} s")

    WA_KERNEL.launches = 0
    GPF_KERNEL.launches = 0
    logits = infer(images)
    torch.cuda.synchronize()
    launches = {"window_attention_fwd": WA_KERNEL.launches, "gpf_fwd": GPF_KERNEL.launches}
    log(f"  launches in one forward: {launches}")
    if launches != {"window_attention_fwd": 24, "gpf_fwd": 1}:
        fail(f"expected 24 window-attention and 1 GPF launch per forward, got {launches}")
    if tuple(logits.shape) != (BATCH, 80) or not torch.isfinite(logits).all():
        fail(f"logits shape {tuple(logits.shape)} or non-finite values")

    with plain_kernels():
        ref = infer(images)
    torch.cuda.synchronize()
    with bias_omitted(model):
        ctrl = infer(images)
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())
    err = (logits.float() - ref.float()).abs().max().item()
    err_ctrl = (ctrl.float() - ref.float()).abs().max().item()
    tol = TOL_LOGITS_REL[torch.bfloat16]
    log(f"  bf16 logits kernel vs plain: max_abs_err={err:.4e} ({err / scale:.4e} of max "
        f"|logit| {scale:.4e}); control (kernel without bias) {err_ctrl:.4e} "
        f"({err_ctrl / scale:.4e}); tol {tol} x max")
    if err > tol * scale:
        fail("bf16 serving logits disagree with the plain path")
    if err_ctrl <= tol * scale:
        fail("bf16 serving check passes the kernel with its bias omitted")

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

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                infer(images)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, "serving_profile.txt"), "w") as f:
            f.write(f"{card}\nbatch {BATCH}, 3 forwards\n{table}\n")
        log(f"  profile written to {profile_dir}/serving_profile.txt")

    del model, infer, logits, ref, ctrl
    torch.cuda.empty_cache()

    # fp32 at batch 8: kernel vs plain with a tight tolerance
    f32_cfg = json.loads(json.dumps(FLAGSHIP))
    f32_cfg["model"]["bf16"] = False
    f32_cfg["model"]["moment"]["bf16_params"] = False
    model32 = create_model(f32_cfg, num_classes=80, device="cuda", seed=0)
    redraw_bias_tables(model32, torch.Generator(device=dev).manual_seed(0))
    infer32 = make_infer_fn(model32, aug)
    out32 = infer32(images[:8])
    with plain_kernels():
        ref32 = infer32(images[:8])
    torch.cuda.synchronize()
    err32 = (out32 - ref32).abs().max().item()
    scale32 = max(1.0, ref32.abs().max().item())
    log(f"  fp32 logits (batch 8) kernel vs plain: max_abs_err={err32:.4e}, max |logit|="
        f"{scale32:.4e} (tol {TOL_LOGITS_REL[torch.float32]} x max)")
    if not torch.isfinite(out32).all() or err32 > TOL_LOGITS_REL[torch.float32] * scale32:
        fail("fp32 serving logits disagree with the plain path")
    return {"launches": launches, "images_per_s": ips, "peak_gib": peak}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", help="write a torch.profiler table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.time()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("[1] building kernels")
    t0 = time.time()
    paths = _build.build()
    log(f"  built {len(paths)} kernels in {time.time() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[2] kernels against their plain versions, batch 64")
    g = torch.Generator(device="cuda").manual_seed(1234)
    with torch.inference_mode():
        wa = check_window_attention(g)
        gp = check_gpf(g)

    log("[3] serving, Swin-Base/224 flagship, batch 64")
    srv = serve(card, args.profile)

    kernels = [
        {"name": "window_attention_fwd", "route": "cuda",
         "source": "ego_moment_cle_vit_tpu_torch/csrc/window_attention_fwd.cu",
         "replaces": WA_REPLACES, "launches": srv["launches"]["window_attention_fwd"],
         "max_abs_err": wa["max_abs_err"], "ms": wa["ms"], "plain_ms": wa["plain_ms"],
         "bound_ms": wa["bound_ms"], "bound_by": wa["bound_by"],
         "library_ms": wa["library_ms"]},
        {"name": "gpf_fwd", "route": "cuda",
         "source": "ego_moment_cle_vit_tpu_torch/csrc/gpf_fwd.cu",
         "replaces": GPF_REPLACES, "launches": srv["launches"]["gpf_fwd"],
         "max_abs_err": gp["max_abs_err"], "err_over_tol": gp["err_over_tol"],
         "ms": gp["ms"], "plain_ms": gp["plain_ms"],
         "bound_ms": gp["bound_ms"], "bound_by": gp["bound_by"],
         "library_ms": gp["library_ms"]},
    ]
    log(f"  total {time.time() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
