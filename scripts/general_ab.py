#!/usr/bin/env python3
"""Time the general path of one or more checkouts, in turns, on one NVIDIA GPU.

    python3 scripts/general_ab.py --roots DIR [DIR ...]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each DIR is a checkout (`.` for this one, or an earlier one unpacked by
`git archive` under build/); each is run in a process of its own, which
imports the `mpm_flip98a_tpu_torch` package under DIR (and builds its
kernels there), so that two versions can be compared in one call in the
order given (parent, change, change, parent).  At each cell, from the
cell's initial state on the card:

- bench 1M: `bench.py:179-189` (1M particles, 513^2, float32, PIC with
  FLIP 0.98), 3 x 20 substeps;
- slab 1M: `scenes.slab_3d()` (1M particles, 128^3, float32), 3 x 5;

it prints ms per substep (host clock with a synchronise, median of the
three), the device busy time per substep (torch.profiler over 5 (2)
substeps after 2) and the idle share against the unprofiled time, the
scatter launches a substep, and the card's name and power limit: one
JSON line per root and cell.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELLS = {"bench1M": 20, "slab1M": 5}


def one(root: Path) -> int:
    sys.path.insert(0, str(root.resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import scenes, stabilized
    from mpm_flip98a_tpu_torch.ops.cuda import scatter
    from mpm_flip98a_tpu_torch.state import to_device

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for tag, n_sub in CELLS.items():
        if tag == "bench1M":
            p, scene = scenes.dam_break_2d(MPMConfig(
                dtype="float32", num_grids=513, dt=2e-6, num_particles_x=2000,
                num_particles_y=500, fluid_width=0.430, fluid_height=0.215, flip_blend=0.98,
                transfer=TransferKind.PIC), dtype=np.float32)
        else:
            p, scene = scenes.slab_3d(num_grids=128, particles_per_axis=(256, 256, 16))
        state = to_device(p, dev)
        stabilized.run(state, scene, 2)
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            stabilized.run(state, scene, n_sub)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0) / n_sub)
        ms = float(np.median(runs))
        n_prof = 5 if tag == "bench1M" else 2
        scatter.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stabilized.run(state, scene, n_prof)
            torch.cuda.synchronize()
        busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e3 / n_prof
        print(json.dumps({"root": str(root), "cell": tag, "ms_per_substep": ms, "runs": runs,
                          "busy_ms": busy, "idle_share": 1.0 - busy / ms,
                          "scatter_launches_per_substep": scatter.LAUNCHES["scatter"] / n_prof,
                          "card": card}), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", type=Path, nargs="+", help="checkouts to time, in turn")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        return one(args.one)
    rc = 0
    for root in args.roots:
        rc |= subprocess.run([sys.executable, __file__, "--one", str(root)], cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
