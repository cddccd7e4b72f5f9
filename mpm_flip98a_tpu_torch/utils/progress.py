"""Console progress bar — the reference's `progressBar(t, T)` equivalent
(exec.py:28, part of the withheld module's public API, exec.py:5)."""

from __future__ import annotations

import sys


def progress_bar(t: float, total: float, width: int = 40, extra: str = "") -> None:
    frac = min(max(t / total, 0.0), 1.0)
    filled = int(width * frac)
    bar = "#" * filled + "-" * (width - filled)
    sys.stdout.write(f"\r[{bar}] {100 * frac:5.1f}%  t={t:.4f}/{total:g}s {extra}")
    if frac >= 1.0:
        sys.stdout.write("\n")
    sys.stdout.flush()


def create_file_paths(tag: str, base: str = "out") -> tuple[str, str]:
    """`createFilePaths(numerical)` equivalent (exec.py:16): returns
    (frame_dir, vtk_dir) named by the run tag, mirroring the reference's
    `mov_dt1e-6_pointwise/` / `vtk_dt1e-6_pointwise/` convention
    (.gitignore:3-4)."""
    import os

    frame_dir = os.path.join(base, f"mov_{tag}")
    vtk_dir = os.path.join(base, f"vtk_{tag}")
    os.makedirs(frame_dir, exist_ok=True)
    os.makedirs(vtk_dir, exist_ok=True)
    return frame_dir, vtk_dir
