"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu -lcuda

at first use, into ``ego_moment_cle_vit_tpu_torch/_build/`` (git-ignored),
keyed on a hash of the sources and flags so an edit rebuilds.  ``build()``
starts one nvcc per source at once and waits for all of them.  Nothing here
runs when a module is imported.

``launch`` is every wrapper's launch protocol: the device's context bound to
the thread, the library loaded, the ``kernel.<wrapper>`` span
(``utils/trace.py``), the stream, the return code and the
``<wrapper>.launches`` count, which the benchmark and the card tests read.  A wrapper names itself to it as ``"<module>:<function>"``, the way
``h100_bench/kernel_work`` names it.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

from ..utils.trace import span

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = tuple(sorted(p.stem for p in CSRC_DIR.glob("*.cu")))  # one library each
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
_thread = threading.local()  # .devices: the devices whose context this thread has bound


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


def launch(wrapper: str, source: str, signatures: dict, device: torch.device, *args) -> None:
    """Launch the kernel of ``wrapper``, ``"<module>:<function>"``: load
    ``source``'s library and call its entry point, the first C function
    ``signatures`` declares, with ``args`` and ``device``'s current stream,
    inside the span ``"kernel.<function>"``.  A CUDA error raises naming the
    function; otherwise the launch counts one in the ``launches`` of whatever
    the module's name ``<function>`` holds (a stand-in put there counts in
    the wrapper's place).  ``args`` are pointers and scalars only: the caller
    keeps every tensor they point into alive."""
    module, name = wrapper.split(":")
    bind_context(device)
    lib = load(source, signatures)
    entry = getattr(lib, next(iter(signatures)))
    with span("kernel." + name):
        code = entry(*args, stream_ptr(device))
    check(lib, code, name)
    getattr(sys.modules[module], name).launches += 1


def bind_context(device: torch.device) -> None:
    """Make ``device``'s primary context current on this thread, once a
    thread.  The libraries encode their TMA tensor maps with libcuda's
    ``cuTensorMapEncodeTiled`` before any runtime call, and it fails
    (invalid argument) on a thread where no context is current: a new
    thread, or autograd's device thread, whose first CUDA work is a launch.
    A runtime call, a query of the device's stream, binds the context."""
    devices = _thread.__dict__.setdefault("devices", set())
    if device not in devices:
        torch.cuda.current_stream(device).query()
        devices.add(device)


def wrappers() -> dict:
    """{name: wrapper} of every kernel wrapper: the functions of the kernel
    modules that count their launches in ``<wrapper>.launches``."""
    found = {}
    for path in sorted(Path(__file__).parent.glob("[!_]*.py")):
        module = importlib.import_module(f"{__package__}.{path.stem}")
        found.update({name: fn for name, fn in vars(module).items()
                      if hasattr(fn, "launches") and fn.__module__ == module.__name__})
    return found


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]
