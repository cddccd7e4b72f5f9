"""Legacy-VTK particle export.

The reference's `post_process` writes one VTK particle file per frame into
a `vtk_dt1e-6_pointwise/`-style directory (exec.py:29; .gitignore:4 names
the artifacts).  This writes the same kind of artifact — ASCII legacy VTK
POLYDATA with per-particle scalars — readable by ParaView, no external
dependency."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def write_vtk_particles(
    path: str,
    x: np.ndarray,
    scalars: Optional[Dict[str, np.ndarray]] = None,
    vectors: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """x: (N, 2 or 3); scalars: name -> (N,); vectors: name -> (N, 2|3)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n, d = x.shape
    x3 = np.zeros((n, 3), np.float64)
    x3[:, :d] = x
    lines = [
        "# vtk DataFile Version 3.0",
        "mpm_flip98a_tpu particles",
        "ASCII",
        "DATASET POLYDATA",
        f"POINTS {n} double",
    ]
    lines += [" ".join(f"{v:.9g}" for v in row) for row in x3]
    lines.append(f"VERTICES {n} {2 * n}")
    lines += [f"1 {i}" for i in range(n)]
    if scalars or vectors:
        lines.append(f"POINT_DATA {n}")
    for name, s in (scalars or {}).items():
        lines.append(f"SCALARS {name} double 1")
        lines.append("LOOKUP_TABLE default")
        lines += [f"{v:.9g}" for v in np.asarray(s, np.float64)]
    for name, vec in (vectors or {}).items():
        v3 = np.zeros((n, 3), np.float64)
        v3[:, : vec.shape[1]] = vec
        lines.append(f"VECTORS {name} double")
        lines += [" ".join(f"{v:.9g}" for v in row) for row in v3]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_vtk_points(path: str) -> np.ndarray:
    """Read back POINTS from a legacy VTK file (round-trip tests / restart).
    Handles both the ASCII files this module writes and the BINARY
    big-endian files the native writer emits (utils/native_io.py)."""
    with open(path, "rb") as f:
        data = f.read()
    header = data[:4096]
    if b"\nBINARY\n" in header:
        at = data.index(b"POINTS")
        eol = data.index(b"\n", at)
        _, n_s, dtype_s = data[at:eol].split()
        n = int(n_s)
        dt = {b"float": ">f4", b"double": ">f8"}[dtype_s]
        start = eol + 1
        vals = np.frombuffer(data, dt, count=3 * n, offset=start)
        return vals.astype(np.float64).reshape(n, 3)
    tokens = data.decode().split()
    i = tokens.index("POINTS")
    n = int(tokens[i + 1])
    vals = np.array(tokens[i + 3 : i + 3 + 3 * n], np.float64)
    return vals.reshape(n, 3)
