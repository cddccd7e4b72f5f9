#!/usr/bin/env python3
"""Time the general path's transfer building blocks in their variants on one NVIDIA GPU.

    python3 scripts/general_gather_variants.py

Run from the root of a checkout, on a machine with a CUDA card (no nvcc
needed: nothing here is a hand-written kernel).  The general path
(`models/stabilized.py`) gathers the updated grid at every stencil node of
every particle and assembles the P2G channels in plain torch; these are
the ways of doing so that were measured, at the shapes of two cells:

- bench1M: the bench dam break (1M particles, 513^2: bench.py:179-189),
  float32, 9 taps, the 4-channel G2P grid [v_new, v0];
- slab1M: scenes.slab_3d() (1M particles, 128^3), float32, 27 taps, the
  6-channel G2P grid.

Gather variants, all of which must agree bitwise:
- index_select: rows of c channels, `grid.reshape(-1, c).index_select`;
- rows_index: the same by advanced indexing, `grid.reshape(-1, c)[flat]`;
- channel_stack: one gather per channel, stacked on the last dimension;
- elements: one element-wise gather over (N, S, c) element indices;
- kept: `ops/transfer.g2p_gather`, which takes elements where a row is a
  multiple of 16 bytes and index_select otherwise.

Channel assembly at the same shapes ([momentum (d), momentum + force (d),
mass, volume] of the fused momentum P2G): `torch.cat` of the three parts
against writing them into one preallocated buffer (kept).

CUDA events, 20 calls after 3 warm-up calls; each line carries the card's
name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind  # noqa: E402
from mpm_flip98a_tpu_torch.models import scenes, stabilized  # noqa: E402
from mpm_flip98a_tpu_torch.ops import transfer  # noqa: E402

BENCH = dict(dtype="float32", num_grids=513, dt=2e-6, num_particles_x=2000,
             num_particles_y=500, fluid_width=0.430, fluid_height=0.215, flip_blend=0.98)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gathers(grid, flat, in_bounds):
    rows = grid.reshape(-1, grid.shape[-1])
    c = rows.shape[-1]
    masked = lambda v: torch.where(in_bounds[..., None], v, 0.0)
    return {
        "index_select": lambda: masked(
            rows.index_select(0, flat.reshape(-1)).reshape(flat.shape + (c,))),
        "rows_index": lambda: masked(rows[flat]),
        "channel_stack": lambda: masked(torch.stack([rows[:, k][flat] for k in range(c)], -1)),
        "elements": lambda: masked(grid.reshape(-1)[flat[..., None] * c + torch.arange(
            c, device=grid.device)]),
        "kept": lambda: transfer.g2p_gather(grid, None, None, (flat, in_bounds)),
    }


def assemblies(n, s, d, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    mv_pure = torch.rand((n, s, d), generator=g, device=dev)
    mv_forced = torch.rand((n, s, d), generator=g, device=dev)
    mass, vol = torch.rand((n,), generator=g, device=dev), torch.rand((n,), generator=g, device=dev)

    def cat():
        ones = torch.ones((n, s), device=dev)
        extra = torch.stack([mass[:, None] * ones, vol[:, None] * ones], dim=-1)
        return torch.cat([mv_pure, mv_forced, extra], dim=-1)

    def buffer():
        out = torch.empty((n, s, 2 * d + 2), device=dev)
        out[..., 0:d] = mv_pure
        out[..., d:2 * d] = mv_forced
        out[..., 2 * d] = mass[:, None]
        out[..., 2 * d + 1] = vol[:, None]
        return out

    return {"cat": cat, "buffer": buffer}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    cases = {
        "bench1M": scenes.dam_break_2d(MPMConfig(**BENCH, transfer=TransferKind.PIC),
                                       dtype=np.float32),
        "slab1M": scenes.slab_3d(),
    }
    for tag, (p, scene) in cases.items():
        cfg = scene.cfg
        x = p.x.to(dev)
        offsets, base, _, _ = stabilized._weights(stabilized._grid_coords(x, cfg), cfg)
        flat, in_bounds, _ = transfer.flat_node_index(base, offsets, cfg.grid_shape)
        c = 2 * cfg.dim
        grid = torch.rand(cfg.grid_shape + (c,), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
        want = None
        for name, fn in gathers(grid, flat, in_bounds).items():
            got = fn()
            want = got if want is None else want
            ms = cuda_ms(fn)
            print(f"[gather {tag}] {name}: {ms:.4f} ms a call ({flat.numel()} stencil rows of "
                  f"{c} channels), bitwise equal to index_select: {torch.equal(got, want)}  "
                  f"[{card}]", flush=True)
            if not torch.equal(got, want):
                return 1
        n, s = flat.shape
        for name, fn in assemblies(n, s, cfg.dim, dev).items():
            print(f"[channels {tag}] {name}: {cuda_ms(fn):.4f} ms a call ({n} x {s} x "
                  f"{2 * cfg.dim + 2})  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
