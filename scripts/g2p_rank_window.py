#!/usr/bin/env python3
"""Time `g2p` (prepadded, 4 channels) on one rank's window of bench 1M, alone on one NVIDIA GPU.

    python3 scripts/g2p_rank_window.py [--shard 1] [--substeps 20]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
bench 1M (`bench.py:179-189`: 1M particles, 513^2, PIC with FLIP 0.98,
float32) runs `--substeps` substeps in 4 slab shards of 129 rows
(`Simulation(devices=4)`, `SlabMesh(4)`); then the sharded substep's
inputs to `g2p` are made once (the raw `p2g_grid` sums, halo-synced and
grid-updated) and `g2p` is timed on shard `--shard`'s window alone: the
inputs a rank of `--devices 4 --ranks` holds, whose rows are bitwise
SlabMesh's shard (tests/test_torch_fast_ranks.py), with no other process
on the card.  The same call on all 4 shards at once is timed beside it.
It prints one JSON line: kernel and plain ms (CUDA events, chip_smoke's
`cuda_ms`: median of 20 calls after 3, three times for the kernel), the
bound (`chip_smoke.bound`: every input read once and every output written
once at 3.35 TB/s, or the multiply-adds at 67 TFLOP/s), the window's rows
and live slots, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shard", type=int, default=1)
    ap.add_argument("--substeps", type=int, default=20)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("g2p_rank_window: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mpm_flip98a_tpu_torch import _build, driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk
    from mpm_flip98a_tpu_torch.parallel import fast_domain

    _build.load()
    dev = torch.device("cuda", 0)
    p, scene = scenes.dam_break_2d(MPMConfig(**cs.BENCH, transfer=TransferKind.PIC),
                                   dtype=np.float32)
    cfg = scene.cfg
    sim = driver.Simulation(p, scene, path="fast", out_dir=tempfile.gettempdir(), device=dev,
                            devices=4)
    sim.step_frame(args.substeps)
    ctx = fast_domain.FastDomainCtx(sim.mesh, sim.spec.rows_per_shard)
    data, pdata2, counts = fast2d.transfer_inputs(sim.state, scene, ctx)
    grid = fast2d._grid(data, counts, scene, False, ctx)
    dx, dinv = float(cfg.dx), float(4.0 * cfg.inv_dx * cfg.inv_dx)
    rows = sim.spec.rows_per_shard
    win = slice(args.shard * rows, (args.shard + 1) * rows)
    inputs = {"window": (pdata2[win].contiguous(), counts[win].contiguous(),
                         grid[args.shard:args.shard + 1].contiguous()),
              "4 shards": (pdata2, counts, grid)}
    out = {"card": cs.card_line(), "shard": args.shard, "rows": rows,
           "substeps_before": args.substeps}
    for name, (pd, cn, gr) in inputs.items():
        call = lambda: tk.g2p(pd, cn, gr, dx, dinv, prepadded=True)
        got = call()
        want = tk.g2p_plain(pd, cn, gr, dx, dinv, prepadded=True)
        live = int(cn.sum())
        b_ms, b_by = cs.bound(4 * (3 * live + cn.numel() + gr.numel() + got.numel()),
                              live * 9 * gr.shape[2] * 2)
        out[name] = {
            "live": live, "grid": list(gr.shape),
            "max_abs_err": float((got - want).abs().max()),
            "ms_runs": [cs.cuda_ms(call) for _ in range(3)],
            "plain_ms": cs.cuda_ms(lambda: tk.g2p_plain(pd, cn, gr, dx, dinv, prepadded=True),
                                   reps=3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by}
        out[name]["ms"] = float(np.median(out[name]["ms_runs"]))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
