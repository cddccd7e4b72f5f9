#!/usr/bin/env python3
"""Time variants of the port's fixed-order P2G gathers (2D `p2g`,
`p2g_fused`, `p2g_grid`; 3D `p2g3d`) on one NVIDIA GPU.

    python3 scripts/p2g_variants.py [--parent DIR] [--only NAME ...]
                                    [--states NAME ...]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the committed `mpm_flip98a_tpu_torch/csrc/p2g.cu` and `p2g3d.cu`
and variants of them (other sources beside them, or other plans from the
host's planner), each into its own library under build/p2g_variants/,
swaps each library in behind the wrappers `ops/cuda/transfer2d.p2g`,
`p2g_fused`, `p2g_grid` and `transfer3d.p2g3d`, and times one call with
CUDA events at these states (--states picks some):

- bench1M: the bench dam break (1M particles, 513^2: bench.py:179-189),
  PIC, after 20 substeps: `p2g_fused`;
- stab1M: the same with the stabilized switch set, 9 channels: `p2g`;
- drop1M: elastic_drop_2d with stab1M's config: `p2g`;
- bench1Mx4, stab1Mx4: bench1M and stab1M through Simulation(devices=4)
  (4 slab shards of 129 rows, 5120 slots a bucket row) after 20
  substeps: `p2g_grid`'s fused and prepped 9-channel raw modes;
- relfloor3d: the 8M slab (BASELINE.json configs[3], 256^3) with the
  stabilized switch set and the relative mass floor after 5 substeps,
  11 channels, PIC: `p2g3d` (and its tent taps).

With --parent DIR (a checkout of an earlier commit, e.g. `git archive` of
it unpacked there), that commit's kernels are built too and called through
its own C entries (PARENT_SIGNATURES: the shared-memory-atomic
`mpm_p2g_fused` and `mpm_p2g_grid`, with no plan arguments), timed in
turns with the committed kernels (parent, committed, committed, parent).

Variants (each against the committed kernel's output: max |diff|, and
whether two calls are bitwise equal):
- committed: the sources and plans as they are (`p2g_grid`: the gather
  over every shard's rows into a scratch buffer, then the fold);
- rows_tile1, rows_tile2, rows_tile4 (`p2g_grid` only): the one-launch
  design of scripts/variants/p2g_grid_rows.cu, a block per tile of 1, 2
  or 4 halo rows that runs the gather once per source bucket row and
  folds in registers;
- band128: column bands of at most 128 columns (256 committed: 3 bands at
  G = 513), more blocks a bucket row.

It also prints each build's registers and spills (ptxas) and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mpm_flip98a_tpu_torch import _build, driver  # noqa: E402
from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind  # noqa: E402
from mpm_flip98a_tpu_torch.models import fast2d, fast3d, scenes  # noqa: E402
from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk  # noqa: E402
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3  # noqa: E402
from mpm_flip98a_tpu_torch.parallel import fast_domain  # noqa: E402

CSRC = ROOT / "mpm_flip98a_tpu_torch" / "csrc"
FILES = ("p2g.cu", "p2g3d.cu", "taps.cuh")
ENTRIES = ("mpm_p2g", "mpm_p2g_fused", "mpm_p2g_grid", "mpm_p2g3d")
ROWS = Path(__file__).resolve().parent / "variants" / "p2g_grid_rows.cu"
OUT = ROOT / "build" / "p2g_variants"
BENCH = dict(dtype="float32", num_grids=513, dt=2e-6, num_particles_x=2000,
             num_particles_y=500, fluid_width=0.430, fluid_height=0.215, flip_blend=0.98)
STAB = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0)
STATES = ("bench1M", "stab1M", "drop1M", "bench1Mx4", "stab1Mx4", "relfloor3d")
TILE = "constexpr int kTile = 1;"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# scripts/variants/p2g_grid_rows.cu: mpm_p2g_grid's arguments without the
# expanded scratch.
ROWS_SIGNATURE = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _F, _F, _F, _F, _F,
                  _I, _I, _P)
# The C entries of the parent commit (741c009) whose signatures differ
# from the committed ones: no plan arguments.
PARENT_SIGNATURES = {
    # sdata, counts, out, R, K, G, dx, apic, tait, kb, kb/gamma, gamma, 2 mu,
    # mu, fa, stream
    "mpm_p2g_fused": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _F, _F, _F, _F, _F, _F, _P),
    # data, counts, out, shards, L, K, G, nch, fused, tent, dx, apic, tait,
    # kb, kb/gamma, gamma, 2 mu, mu, fa, stream
    "mpm_p2g_grid": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _F, _F, _F,
                     _F, _F, _P),
}


def sources() -> dict:
    return {f: (CSRC / f).read_text() for f in FILES}


def variants() -> dict:
    """name -> (sources, planner overrides)."""
    src = sources()
    rows = ROWS.read_text()
    return {
        "committed": (src, {}),
        **{f"rows_tile{t}": ({**src, ROWS.name: rows.replace(TILE, TILE.replace("1", str(t)))},
                             {}) for t in (1, 2, 4)},
        "band128": (src, {"P2G_MAX_BAND": 128}),
    }


def bind(lib_path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build(name: str, files: dict) -> _build.Build:
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    (d / "csrc").mkdir(parents=True)
    for f, text in files.items():
        (d / "csrc" / f).write_text(text)
    log = _build._compile_and_link([d / "csrc" / f for f in files], d / "lib.so")
    sigs = {fn: _build.SIGNATURES[fn] for fn in ENTRIES}
    if ROWS.name in files:
        sigs["mpm_p2g_grid_rows"] = ROWS_SIGNATURE
    lib = bind(d / "lib.so", sigs)
    return _build.Build(lib, d / "lib.so", 0.0, False, log)


def build_parent(parent: Path) -> ctypes.CDLL:
    """The earlier commit's P2G kernels (every .cu of its csrc that defines
    one of ENTRIES, and its headers), bound with PARENT_SIGNATURES where
    they differ from the committed entries."""
    d = OUT / "parent"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(parent / "mpm_flip98a_tpu_torch" / "csrc", d / "csrc")
    srcs = [s for s in sorted((d / "csrc").glob("*.cu"))
            if any(f"int {fn}(" in s.read_text() for fn in ENTRIES)]
    _build._compile_and_link(srcs + sorted((d / "csrc").glob("*.cuh")), d / "lib.so")
    return bind(d / "lib.so", {fn: PARENT_SIGNATURES.get(fn, _build.SIGNATURES[fn])
                               for fn in ENTRIES})


def parent_p2g(lib, pdata, counts, g, dx, tent, apic):
    r, f, k = pdata.shape
    plan = tk.plan_p2g(f - 8, g, k, apic)
    out = torch.empty((r, tk.NT, f - 8, g), dtype=torch.float32, device=pdata.device)
    tk._raise_on(lib.mpm_p2g(tk._ptr(pdata), tk._ptr(counts), tk._ptr(out), r, k, g, f - 8, dx,
                             int(apic), int(tent), plan.band, plan.cap, tk._stream(pdata)),
                 "parent p2g")
    return out


def parent_p2g_fused(lib, sdata, counts, g, dx, apic, eos, kb, mu, gamma, fa):
    r, _, k = sdata.shape
    out = torch.empty((r, tk.NT, tk.P2G_CH_FUSED, g), dtype=torch.float32, device=sdata.device)
    tk._raise_on(lib.mpm_p2g_fused(
        tk._ptr(sdata), tk._ptr(counts), tk._ptr(out), r, k, g, dx, int(apic),
        tk.EOS_CODES[eos], kb, kb / gamma, gamma, 2.0 * mu, mu, fa, tk._stream(sdata)),
        "parent p2g_fused")
    return out


def parent_p2g_grid(lib, data, counts, g, dx, *, fused, tent=False, apic=True, eos="tait",
                    kb=0.0, mu=0.0, gamma=7.0, fa=0.0, shards=1):
    r, f, k = data.shape
    nch = tk.P2G_CH_FUSED if fused else f - 8
    l = r // shards
    out = torch.empty((shards, l + tk.NT - 1, nch, g), dtype=torch.float32, device=data.device)
    tk._raise_on(lib.mpm_p2g_grid(
        tk._ptr(data), tk._ptr(counts), tk._ptr(out), shards, l, k, g, nch, int(fused),
        int(tent), dx, int(apic), tk.EOS_CODES[eos], kb, kb / gamma, gamma, 2.0 * mu, mu, fa,
        tk._stream(data)), "parent p2g_grid")
    return out


def parent_p2g3d(lib, fields, counts, g1, g2, dx, apic, ext, tent):
    r0, r1, k, strides = tk3._check_fields(fields, tk3.n_prepped(apic, ext))
    nch = tk3.P2G_CH_EXT if ext else tk3.P2G_CH
    plan = tk3.plan_p2g3d(nch, g2, k, apic)
    out = torch.empty((r0, tk3.NT, g1, nch, g2), dtype=torch.float32, device=counts.device)
    ptrs, pstr = tk3._prepped_plane_args(fields, strides, apic, ext)
    tk._raise_on(lib.mpm_p2g3d(ptrs, pstr, tk._ptr(counts), tk._ptr(out), r0, r1, k, g1, g2, nch,
                               int(apic), int(tent), dx, plan.band, plan.cap,
                               tk._stream(counts)), "parent p2g3d")
    return out


def rows_p2g_grid(lib, data, counts, g, dx, *, fused, tent=False, apic=True, eos="tait",
                  kb=0.0, mu=0.0, gamma=7.0, fa=0.0, shards=1):
    """p2g_grid through scripts/variants/p2g_grid_rows.cu, on
    plan_p2g's plan."""
    r, f, k = data.shape
    nch = tk.P2G_CH_FUSED if fused else f - 8
    l = r // shards
    plan = tk.plan_p2g(nch, g, k, apic)
    out = torch.empty((shards, l + tk.NT - 1, nch, g), dtype=torch.float32, device=data.device)
    tk._raise_on(lib.mpm_p2g_grid_rows(
        tk._ptr(data), tk._ptr(counts), tk._ptr(out), shards, l, k, g, nch, int(fused),
        int(tent), dx, int(apic), tk.EOS_CODES[eos], kb, kb / gamma, gamma, 2.0 * mu, mu, fa,
        plan.band, plan.cap, tk._stream(data)), "rows p2g_grid")
    return out


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


def states(dev, wanted):
    """(tag, call(tent) of the committed wrapper, parent call(lib, tent),
    the rows variant's call(lib) or None, bytes in + out, what) for each
    wanted state."""
    cfg = MPMConfig(**BENCH, transfer=TransferKind.PIC)
    cfg_stab = MPMConfig(**BENCH, **STAB, transfer=TransferKind.PIC)
    for tag, c, make in (("bench1M", cfg, scenes.dam_break_2d),
                         ("stab1M", cfg_stab, scenes.dam_break_2d),
                         ("drop1M", cfg_stab, scenes.elastic_drop_2d)):
        if tag not in wanted:
            continue
        p, scene = make(c, dtype=np.float32)
        spec = fast2d.FastSpec.for_particles(c, p)
        b = fast2d.run(fast2d.from_particles(p, c, spec, dev), scene, spec, 20)
        data, _, counts = fast2d.transfer_inputs(b, scene)
        args = fast2d.p2g_args(scene)
        r, f, k = data.shape
        live = int(counts.sum())
        fused = fast2d.uses_fused(scene)
        nch = tk.P2G_CH_FUSED if fused else f - 8
        nbytes = 4 * (f * live + r + 5 * nch * r * args["g"])
        what = f"{live} live, data {tuple(data.shape)}"
        if fused:
            yield (tag, lambda tent=False, a=args, d=data, n=counts: tk.p2g_fused(d, n, **a),
                   lambda lib, tent=False, a=args, d=data, n=counts: parent_p2g_fused(
                       lib, d, n, **a), None, nbytes, what)
        else:
            yield (tag, lambda tent=False, a=args, d=data, n=counts: tk.p2g(
                       d, n, **{**a, "tent": tent}),
                   lambda lib, tent=False, a=args, d=data, n=counts: parent_p2g(
                       lib, d, n, a["g"], a["dx"], tent, a["apic"]), None, nbytes, what)
        del b, data, counts
    for tag, c in (("bench1Mx4", cfg), ("stab1Mx4", cfg_stab)):
        if tag not in wanted:
            continue
        p, scene = scenes.dam_break_2d(c, dtype=np.float32)
        sim = driver.Simulation(p, scene, out_dir=str(OUT), device=dev, devices=4)
        sim.run(1, 20, gif=False, verbose=False, write_frames=False)
        ctx = fast_domain.FastDomainCtx(sim.mesh, sim.spec.rows_per_shard)
        data, _, counts = fast2d.transfer_inputs(sim.state, scene, ctx)
        kw = {n: v for n, v in fast2d.p2g_args(scene).items() if n not in ("g", "dx")}
        kw["fused"] = fast2d.uses_fused(scene)
        g, dx = c.num_grids, float(c.dx)
        r, f, k = data.shape
        live = int(counts.sum())
        nch = tk.P2G_CH_FUSED if kw["fused"] else f - 8
        nbytes = 4 * (f * live + r + (r + 16) * nch * g)
        yield (tag, lambda tent=False, d=data, n=counts, kw=kw, g=g, dx=dx: tk.p2g_grid(
                   d, n, g, dx, raw=True, shards=4, **kw),
               lambda lib, tent=False, d=data, n=counts, kw=kw, g=g, dx=dx: parent_p2g_grid(
                   lib, d, n, g, dx, shards=4, **kw),
               lambda lib, d=data, n=counts, kw=kw, g=g, dx=dx: rows_p2g_grid(
                   lib, d, n, g, dx, shards=4, **kw), nbytes,
               f"{live} live, data {tuple(data.shape)}, 4 shards")
        del sim, data, counts
    if "relfloor3d" not in wanted:
        return
    p8, slab = scenes.slab_3d(num_grids=256, particles_per_axis=(512, 512, 32))
    scene = dataclasses.replace(slab, cfg=dataclasses.replace(slab.cfg, **STAB), mass_floor=0.0)
    sim = driver.Simulation(p8, scene, out_dir=str(OUT), device=dev)
    sim.run(1, 5, gif=False, verbose=False, write_frames=False)
    spec = sim.spec
    args = fast3d.p2g_args(scene)
    fields = fast3d.prepped_fields(sim.state, scene, spec)
    counts = fast3d.pencil_counts(sim.state)
    r0, r1, k = fields[0].shape
    g2, dx = args["g2"], args["dx"]
    mode = dict(apic=args["apic"], ext=args["ext"])
    nch = tk3.P2G_CH_EXT if mode["ext"] else tk3.P2G_CH
    live = int(counts.sum())
    nbytes = 4 * (len(fields) * live + r0 * r1 + 5 * nch * r0 * r1 * g2)
    yield ("relfloor3d",
           lambda tent=False: tk3.p2g3d(fields, counts, r1, g2, dx, tent=tent, **mode),
           lambda lib, tent=False: parent_p2g3d(lib, fields, counts, r1, g2, dx, tent=tent, **mode),
           None, nbytes, f"{live} live, {len(fields)} planes, buckets {r0}x{r1}x{k}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--states", nargs="*", default=list(STATES[:5]), choices=STATES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    full = _build.load()     # every kernel, for the runs that make the states
    todo = {n: v for n, v in variants().items() if args.only is None or n in args.only}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(todo) + 1) as ex:
        futs = {n: ex.submit(build, n, v[0]) for n, v in todo.items()}
        fut_parent = ex.submit(build_parent, args.parent) if args.parent else None
        libs = {n: f.result() for n, f in futs.items()}
        parent = fut_parent.result() if fut_parent else None
    print(f"[build] {len(libs)} variants{' and the parent' if parent else ''} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, b in libs.items():
        regs = re.findall(r"Used (\d+) registers", b.log)
        spills = re.findall(r"(\d+) bytes spill stores", b.log)
        print(f"[ptxas] {name}: registers {regs}, spill stores {spills}", flush=True)

    dev = torch.device("cuda", 0)
    consts = {n: getattr(tk, n) for n in ("P2G_BLOCKS_PER_SM", "P2G_MAX_BAND")}
    _build._loaded = full
    for tag, call, pcall, rows, nbytes, what in states(dev, set(args.states)):
        print(f"[{tag}] {what}; bytes in + out {nbytes}", flush=True)
        for tent in (False, True) if tag == "relfloor3d" else (False,):
            label = f"{tag}{' tent' if tent else ''}"
            _build._loaded = libs["committed"]
            want = call(tent)
            if parent is not None:
                t = [cuda_ms(lambda: pcall(parent, tent)), cuda_ms(lambda: call(tent)),
                     cuda_ms(lambda: call(tent)), cuda_ms(lambda: pcall(parent, tent))]
                err = float((pcall(parent, tent) - want).abs().max())
                scale = float(want.abs().max())
                print(f"[{label}] parent {t[0]:.4f} / {t[3]:.4f} ms, committed {t[1]:.4f} / "
                      f"{t[2]:.4f} ms (CUDA events, 20 calls each, in turns); max |diff| "
                      f"parent vs committed {err:.3e} (output max {scale:.3e}); committed at "
                      f"{nbytes / t[1] / 1e6:.0f} GB/s of bytes in + out  [{card}]", flush=True)
            for name, (files, over) in todo.items():
                _build._loaded = libs[name]
                if ROWS.name in files and rows is None:
                    continue            # the rows variants change p2g_grid only
                run = ((lambda: rows(libs[name].lib)) if ROWS.name in files
                       else (lambda: call(tent)))
                for n, v in over.items():
                    setattr(tk, n, v)
                try:
                    got = run()
                    same = torch.equal(got, run())
                    err = float((got - want).abs().max())
                    ms = cuda_ms(run)
                finally:
                    for n, v in consts.items():
                        setattr(tk, n, v)
                print(f"[{label}] {name}: {ms:.4f} ms (CUDA events, 20 calls), max |diff| "
                      f"against committed {err:.3e}, rerun bitwise equal {same}, "
                      f"{nbytes / ms / 1e6:.0f} GB/s  [{card}]", flush=True)
        _build._loaded = full   # the next state's run takes every kernel
        torch.cuda.empty_cache()
    _build._loaded = full
    return 0


if __name__ == "__main__":
    sys.exit(main())
