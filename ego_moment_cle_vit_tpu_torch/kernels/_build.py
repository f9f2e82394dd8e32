"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu -lcuda

at first use, into ``ego_moment_cle_vit_tpu_torch/_build/`` (git-ignored),
keyed on a hash of the sources and flags so an edit rebuilds.  ``build()``
starts one nvcc per source at once and waits for all of them.  Nothing here
runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("window_attention_fwd", "window_attention_bwd", "gpf_fwd", "gpf_bwd",
                  "packed_attention_fwd", "packed_attention_bwd", "flash_attention_fwd",
                  "flash_attention_bwd", "newton_schulz", "newton_schulz_bf16",
                  "newton_schulz_bf16_streamed", "attn_half_fwd", "attn_half_bwd",
                  "subspace_isqrt", "swiglu_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# after the source: the attention backward encodes TMA tensor maps with the
# cuTensorMapEncodeTiled from libcuda
LINK_FLAGS = ("-lcuda",)
# dtype codes understood by the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, Path]:
    """Compile every missing library among ``names``, all nvcc runs at once.

    Returns {name: library path}.  The compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept beside each library as
    ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu"), *LINK_FLAGS]
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failures = []
    for name, (proc, tmp) in jobs.items():
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``name``'s library; ``signatures`` maps each
    C function to (argtypes, restype)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.emct_error_string.argtypes = [ctypes.c_int]
            lib.emct_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.emct_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]
