"""Build the port's CUDA kernels from `csrc/` and load them with ctypes.

At first use, `load()` compiles every `csrc/*.cu` in its own `nvcc`
process, all started together, and links the objects into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), under `build/torch_kernels/<hash>/` beside the package, keyed
by a hash of the sources and flags.  A later process with the same
sources loads the cached library.  Each C entry point returns
`cudaGetLastError()` after its launches; the wrappers in
`ops/cuda/transfer2d.py` and `transfer3d.py` raise when it is not 0.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures of the entry points (csrc/*.cu).  Without argtypes ctypes
# passes every pointer as a 32-bit int.
SIGNATURES = {
    # sdata, counts, out, R, K, G, dx, apic, tait, kb, kb/gamma, gamma, 2 mu,
    # mu, fa, band, cap, stream
    "mpm_p2g_fused": (
        _P, _P, _P, _I, _I, _I, _F, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P,
    ),
    # pdata, counts, out, R, K, G, nch, dx, apic, tent, band, cap, stream
    "mpm_p2g": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    # data, counts, expanded scratch, ranges scratch, out, shards, L, K, G,
    # nch, fused, tent, dx, apic, tait, kb, kb/gamma, gamma, 2 mu, mu, fa,
    # band, cap, raw, dt g (2), floor, lo, hi, wall, dt beta, collider
    # floats, collider ints, colliders, kin, tcol, stream
    "mpm_p2g_grid": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _F, _F,
        _F, _F, _F, _I, _I, _I, _F, _F, _F, _I, _I, _I, _F, _P, _P, _I, _I, _F, _P,
    ),
    # pdata2, counts, grid, out, R, L, pad, K, G, grid channels, tent, dx,
    # dinv, dinv dx, update, alpha, 1 - alpha, dtv, stream
    "mpm_g2p": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _F, _F, _F, _P,
    ),
    # planes, pencil strides, counts, raw (or null), out, R0, L0, R1, K, G2,
    # dx, apic, tait, kb, kb/gamma, gamma, 2 mu, fa, dt g (3), floor, lo, hi,
    # wall, dt beta, collider floats, collider ints, colliders, kin, tcol, raw
    # only, band, records a chunk, stream
    "mpm_p2g3d_grid": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _F, _F, _F, _F, _F,
        _F, _F, _F, _F, _I, _I, _I, _F, _P, _P, _I, _I, _F, _I, _I, _I, _P,
    ),
    # planes, pencil strides, counts, grid, out, R0, L0, R1, K, G2, dx, dinv,
    # alpha, 1 - alpha, dt, stream
    "mpm_g2p3d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P),
    # planes (29), pencil strides, counts, out, R0, R1, K, G1, G2, nch, apic,
    # tent, halo1, dx, stress (0 prepped, 1 linear, 2 Tait), kb, kb/gamma,
    # gamma, 2 mu, fa, band, cap, stream
    "mpm_p2g3d": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _F, _F, _F, _F, _I,
        _I, _P,
    ),
    # planes (29), pencil strides, counts, raw (or null), out, R0, L0, R1, K,
    # G2, nch, apic, tent, dx, dt g (3), floor, lo, hi, wall, dt beta,
    # collider floats, collider ints, colliders, kin, tcol, raw only, band,
    # records a chunk, stream
    "mpm_p2g3d_grid_pdata": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F,
        _I, _I, _I, _F, _P, _P, _I, _I, _F, _I, _I, _I, _P,
    ),
    # planes (4), pencil strides, counts, grid, out, R0, L0, R1, K, G2, grid
    # channels, tent, dx, dinv, stream
    "mpm_g2p3d_gather": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # values, order, starts, out, nodes, channels, taps, g1, g2, stream
    "mpm_segment_sum_f32": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "mpm_segment_sum_f64": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "mpm_segment_sum_bf16": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    # base, keep (or null), particles, d, g0, g1, g2, keys, stream
    "mpm_stencil_keys": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
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


def _compile_and_link(srcs, lib_path: Path) -> str:
    """One `nvcc -c` per source, run in parallel, then one link; returns
    the compilers' output (the ptxas register report)."""
    nvcc = _nvcc()
    tag = f".{os.getpid()}"
    cu = [s for s in srcs if s.suffix == ".cu"]
    objs = [lib_path.with_name(f"{s.stem}{tag}.o") for s in cu]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, obj in zip(cu, objs)
    ]
    log, failed = "", []
    for s, proc in zip(cu, procs):
        out, _ = proc.communicate()
        log += f"== {s.name}\n{out}"
        if proc.returncode != 0:
            failed.append(s.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = lib_path.with_name(f"{tag}.{lib_path.name}")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True,
    )
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
    return log


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
            log_path.write_text(_compile_and_link(srcs, lib_path))
        log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded = Build(lib, lib_path, time.perf_counter() - t0, cached, log)
        return _loaded
