"""ctypes bindings for the native frame-IO library (native/frame_io.cpp).

The native rasterizer + PNG encoder + binary-VTK writer replace the
Python/PIL path for production frame dumps — the same role the bundled
stb_image_write / Canvas stack plays in the reference's native layer
(cpp_validation/taichi.h:16581-16920, :24860-26238).  Every entry point
returns False when the shared library is unavailable (no toolchain) so
callers fall back to the pure-Python writers in utils/render.py /
utils/io_vtk.py — behavior, not availability, is the contract
(pixel-equality pinned by tests/test_native_io.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmpm_frame_io.so")
_lib = None
_unavailable = False


def _load():
    global _lib, _unavailable
    if _lib is not None or _unavailable:
        return _lib
    # Always invoke make: its timestamp check is a no-op when the .so is
    # fresh, and it rebuilds after frame_io.cpp edits instead of silently
    # loading a stale binary (advisor r3).  A missing toolchain only
    # matters when there is no usable .so at all.
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "libmpm_frame_io.so"],
            check=True, capture_output=True,
        )
    except Exception:
        if not os.path.exists(_LIB_PATH):
            _unavailable = True
            return None
        import warnings

        warnings.warn(
            "native frame-io rebuild failed; loading the EXISTING "
            f"{_LIB_PATH} which may be stale relative to frame_io.cpp",
            RuntimeWarning,
            stacklevel=2,
        )
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _unavailable = True
        return None
    lib.mpm_frame_png.restype = ctypes.c_int
    lib.mpm_frame_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_uint,
    ]
    lib.mpm_vtk_particles.restype = ctypes.c_int
    lib.mpm_vtk_particles.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong, ctypes.c_int,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def frame_png(
    path: str,
    x2: np.ndarray,
    colors: np.ndarray,
    res: int,
    extent: float,
    radius: int = 1,
    bg: int = 0x112F41,
) -> bool:
    """Rasterize (N, 2) domain coordinates + (N, 3) u8 colors to PNG.
    Returns False (caller must fall back) if the library is missing."""
    lib = _load()
    if lib is None:
        return False
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xf = np.ascontiguousarray(x2, np.float32)
    cf = np.ascontiguousarray(colors, np.uint8)
    assert xf.shape == (len(xf), 2) and cf.shape == (len(xf), 3)
    rc = lib.mpm_frame_png(
        path.encode(),
        xf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        len(xf), res, ctypes.c_float(extent), radius, bg,
    )
    return rc == 0


def vtk_particles(path: str, x: np.ndarray) -> bool:
    """Legacy BINARY VTK POLYDATA export of (N, 2|3) positions."""
    lib = _load()
    if lib is None:
        return False
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xf = np.ascontiguousarray(x, np.float32)
    n, dim = xf.shape
    rc = lib.mpm_vtk_particles(
        path.encode(),
        xf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, dim,
    )
    return rc == 0
