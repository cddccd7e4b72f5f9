"""Build the port's CUDA kernels from `csrc/` and load them with ctypes.

At first use, `load()` runs `nvcc` once on every `csrc/*.cu` into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), under `build/torch_kernels/<hash>/` beside the package,
keyed by a hash of the sources and flags.  A later process with the same
sources loads the cached library.  Each C entry point returns
`cudaGetLastError()` after its launch; the wrappers in
`ops/cuda/transfer2d.py` raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (csrc/*.cu).  Without argtypes ctypes
# passes every pointer as a 32-bit int.
SIGNATURES = {
    "mpm_p2g_fused": (
        _P, _P, _P, _I, _I, _I, _F, _I, _I, _F, _F, _F, _F, _F, _F, _P,
    ),
    "mpm_g2p": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P),
}


@dataclasses.dataclass(frozen=True)
class Build:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc time, or load time when cached
    cached: bool
    log: str         # nvcc's output (register / shared-memory report)


_lock = threading.Lock()
_loaded: Optional[Build] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the transfer kernels are built "
        "from mpm_flip98a_tpu_torch/csrc at first use"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def load() -> Build:
    """Build (or reuse) and load the kernel library; raises on failure."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        srcs = sources()
        lib_path = BUILD_DIR / _key(srcs) / "libmpm_kernels.so"
        log_path = lib_path.with_name("nvcc.log")
        t0 = time.perf_counter()
        cached = lib_path.exists()
        if not cached:
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f".{os.getpid()}.{lib_path.name}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
            cmd += [str(s) for s in srcs if s.suffix == ".cu"]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            log_path.write_text(log)
            os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
        log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded = Build(lib, lib_path, time.perf_counter() - t0, cached, log)
        return _loaded
