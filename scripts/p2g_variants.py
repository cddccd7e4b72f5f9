#!/usr/bin/env python3
"""Time variants of the port's prepped P2G kernels (2D `p2g`, 3D `p2g3d`)
on one NVIDIA GPU.

    python3 scripts/p2g_variants.py [--parent DIR] [--only NAME ...]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds `mpm_flip98a_tpu_torch/csrc/p2g.cu` and `p2g3d.cu` as committed
and variants of them (text edits of the sources, or other plans from the
host's planner), each into its own library under build/p2g_variants/, swaps
each library in behind the wrappers `ops/cuda/transfer2d.p2g` and
`transfer3d.p2g3d`, and times one call with CUDA events at three states:

- stab1M: the bench dam break (1M particles, 513^2: bench.py:179-189)
  with the stabilized switch set after 20 substeps, 9 channels, PIC;
- drop1M: elastic_drop_2d with the same config after 20 substeps;
- relfloor3d: the 8M slab (BASELINE.json configs[3], 256^3) with the
  stabilized switch set and the relative mass floor after 5 substeps,
  11 channels, PIC (p2g3d's main path), and its tent taps.

With --parent DIR (a checkout of an earlier commit, e.g. `git archive` of
it unpacked there), that commit's p2g.cu and p2g3d.cu are built too and
called through their own C signatures (no plan arguments), timed in turns
with the committed kernels (parent, committed, committed, parent).

Variants (each against the committed kernel's output: max |diff|, and
whether two calls are bitwise equal):
- committed: the sources and plans as they are;
- blocks_alt: 2 blocks an SM in 2D (3 committed), 3 in 3D (2 committed),
  the register caps and the planners' budgets to match;
- band_all (2D): one block per bucket row (P2G_MAX_BAND past G);
- split1, split2 (3D): 1 or 2 threads a z column (4 committed);
- no_regs (3D): the slots' fields not kept in registers from the walk:
  the records staged from device memory after the sort;
- zeros_after (3D): the zero stores after the walk, outside the columns
  with sums (committed: every column first, the sums over them);
- zeros_first (2D): every column first, the sums over them (committed:
  after the walk, outside the columns with sums);
- probe_write: return after the zero stores (in 2D they come first; in
  3D after the walk's loads are issued);
- probe_nozero: no zero stores at all;
- probe_sort: return after the sort (in 3D with the records placed);
- probe_stage: stage the slots but sum none.
The probes write wrong sums: they time what their phases cost.

It also prints each build's registers and spills (ptxas) and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import shutil
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

CSRC = ROOT / "mpm_flip98a_tpu_torch" / "csrc"
FILES = ("p2g.cu", "p2g3d.cu", "taps.cuh")
OUT = ROOT / "build" / "p2g_variants"
BENCH = dict(dtype="float32", num_grids=513, dt=2e-6, num_particles_x=2000,
             num_particles_y=500, fluid_width=0.430, fluid_height=0.215, flip_blend=0.98)
STAB = dict(use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0)
BLOCKS = {"p2g.cu": ("constexpr int kBlocksPerSM = 3;", "constexpr int kBlocksPerSM = 2;"),
          "p2g3d.cu": ("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 3;")}
SPLIT = "constexpr int kSplit = 4;"
IN_REGS = "const bool in_regs = nsrc <= kSteps * kThreads;"
EARLY = "  if (nbins == 0) return;\n"
SORTED_AT = {"p2g.cu": "  gather::place<kWarps>(tag, lo, hi, tmin, cnt, order);\n  __syncthreads();\n",
             "p2g3d.cu": ("    gather::place<kWarps>(tag, lo, hi, tmin, cnt, order);\n  }\n"
                          "  __syncthreads();\n")}
VISITS_AT = "      if (has) {\n"
WALK_AT = "  int lo, hi;\n"
ZERO_2D = ("  gather::zero_outside<kNT, kThreads>(orow, static_cast<long long>(kNch) * G, G, kNch, "
           "c0, bw,\n                                      zlo, zhi);\n")
ZERO_ALL_2D = ("  gather::zero_outside<kNT, kThreads>(out + static_cast<size_t>(i) * kNT * kNch * G, "
               "static_cast<long long>(kNch) * G, G, kNch, c0, bw, c0 + bw, c0 + bw);\n")
ZERO_3D = "gather::zero_outside<kNT, kThreads>(obase, ts, G2, kNch, zb, bw, zb + bw, zb + bw);\n"
ZERO_AFTER_3D = "  gather::zero_outside<kNT, kThreads>(obase, ts, G2, kNch, zb, bw, zlo, zhi);\n"
STCS = (("__stcs(reinterpret_cast<float4*>(at), zero);", "*reinterpret_cast<float4*>(at) = zero;"),
        ("__stcs(at + q, 0.0f);", "at[q] = 0.0f;"),
        ("__stcs(out + t * ts + static_cast<long long>(ch) * cs + z, 0.0f);",
         "out[t * ts + static_cast<long long>(ch) * cs + z] = 0.0f;"))


def sources() -> dict:
    return {f: (CSRC / f).read_text() for f in FILES}


def edit(src: dict, pairs) -> dict:
    """pairs: file -> [(old, new)], each old found exactly as written."""
    out = dict(src)
    for f, todo in pairs.items():
        for old, new in todo:
            if old not in out[f]:
                raise SystemExit(f"variant edit not found in {f}: {old!r}")
            out[f] = out[f].replace(old, new)
    return out


def both(pairs_of) -> dict:
    """The same kind of edit in both kernels: pairs_of(file) -> pairs."""
    return {f: pairs_of(f) for f in ("p2g.cu", "p2g3d.cu")}


def variants() -> dict:
    """name -> (sources, planner overrides)."""
    src = sources()
    return {
        "committed": (src, {}),
        "blocks_alt": (edit(src, {f: [BLOCKS[f]] for f in BLOCKS}),
                       {"P2G_BLOCKS_PER_SM": 2, "P2G3D_BLOCKS_PER_SM": 3}),
        "band_all": (src, {"P2G_MAX_BAND": 4096}),
        "split1": (edit(src, {"p2g3d.cu": [(SPLIT, SPLIT.replace("4", "1"))]}), {}),
        "split2": (edit(src, {"p2g3d.cu": [(SPLIT, SPLIT.replace("4", "2"))]}), {}),
        "no_regs": (edit(src, {"p2g3d.cu": [(IN_REGS, "const bool in_regs = false;")]}), {}),
        "zeros_after": (edit(src, {"p2g3d.cu": [(ZERO_3D, "\n"),
                                                (EARLY, ZERO_AFTER_3D + EARLY)]}), {}),
        "zeros_first": (edit(src, {"p2g.cu": [(ZERO_2D, ""),
                                              (WALK_AT, ZERO_ALL_2D + WALK_AT)]}), {}),
        "probe_write": (edit(src, {"p2g.cu": [(WALK_AT, ZERO_ALL_2D + "  return;\n" + WALK_AT)],
                                   "p2g3d.cu": [(ZERO_3D, ZERO_3D + "  return;\n")]}), {}),
        "probe_nozero": (edit(src, {"p2g.cu": [(ZERO_2D, "")], "p2g3d.cu": [(ZERO_3D, "\n")]}),
                         {}),
        "probe_sort": (edit(src, both(lambda f: [(SORTED_AT[f], SORTED_AT[f] + "  return;\n")])),
                       {}),
        "probe_stage": (edit(src, both(lambda f: [(VISITS_AT,
                                                   VISITS_AT.replace("(has)", "(has && K < 0)"))])),
                        {}),
    }


def build(name: str, files: dict) -> _build.Build:
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    (d / "csrc").mkdir(parents=True)
    for f, text in files.items():
        (d / "csrc" / f).write_text(text)
    log = _build._compile_and_link([d / "csrc" / f for f in FILES], d / "lib.so")
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn in ("mpm_p2g", "mpm_p2g3d"):
        getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
    return _build.Build(lib, d / "lib.so", 0.0, False, log)


def build_parent(parent: Path) -> ctypes.CDLL:
    """The earlier commit's p2g.cu and p2g3d.cu, with their own C
    signatures: mpm_p2g(pdata, counts, out, R, K, G, nch, dx, apic, tent,
    stream) and mpm_p2g3d(planes, strides, counts, out, R0, R1, K, G1, G2,
    nch, apic, tent, dx, stream)."""
    src = parent / "mpm_flip98a_tpu_torch" / "csrc"
    d = OUT / "parent"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d / "csrc")
    _build._compile_and_link([d / "csrc" / f for f in FILES], d / "lib.so")
    lib = ctypes.CDLL(str(d / "lib.so"))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpm_p2g.argtypes = [P, P, P, I, I, I, I, F, I, I, P]
    lib.mpm_p2g3d.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, F, P]
    lib.mpm_p2g.restype = lib.mpm_p2g3d.restype = ctypes.c_int
    return lib


def parent_p2g(lib, pdata, counts, g, dx, tent, apic):
    r, f, k = pdata.shape
    out = torch.empty((r, tk.NT, f - 8, g), dtype=torch.float32, device=pdata.device)
    tk._raise_on(lib.mpm_p2g(tk._ptr(pdata), tk._ptr(counts), tk._ptr(out), r, k, g, f - 8, dx,
                             int(apic), int(tent), tk._stream(pdata)), "parent p2g")
    return out


def parent_p2g3d(lib, fields, counts, g1, g2, dx, apic, ext, tent):
    r0, r1, k, strides = tk3._check_fields(fields, tk3.n_prepped(apic, ext))
    nch = tk3.P2G_CH_EXT if ext else tk3.P2G_CH
    out = torch.empty((r0, tk3.NT, g1, nch, g2), dtype=torch.float32, device=counts.device)
    ptrs, pstr = tk3._prepped_plane_args(fields, strides, apic, ext)
    tk._raise_on(lib.mpm_p2g3d(ptrs, pstr, tk._ptr(counts), tk._ptr(out), r0, r1, k, g1, g2, nch,
                               int(apic), int(tent), dx, tk._stream(counts)), "parent p2g3d")
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


def states(dev):
    """(tag, call(tent) of the committed wrapper, parent call(lib, tent),
    output bytes, input bytes) at stab1M, drop1M and relfloor3d."""
    cfg = MPMConfig(**BENCH, **STAB, transfer=TransferKind.PIC)
    for tag, make in (("stab1M", scenes.dam_break_2d), ("drop1M", scenes.elastic_drop_2d)):
        p, scene = make(cfg, dtype=np.float32)
        spec = fast2d.FastSpec.for_particles(cfg, p)
        b = fast2d.run(fast2d.from_particles(p, cfg, spec, dev), scene, spec, 20)
        pdata, _, counts = fast2d.transfer_inputs(b, scene)
        args = fast2d.p2g_args(scene)
        r, f, k = pdata.shape
        live = int(counts.sum())
        nbytes = 4 * (f * live + r + 5 * (f - 8) * r * args["g"])
        yield (tag, lambda tent=False, a=args, pd=pdata, c=counts: tk.p2g(pd, c, **{**a, "tent": tent}),
               lambda lib, tent=False, a=args, pd=pdata, c=counts: parent_p2g(
                   lib, pd, c, a["g"], a["dx"], tent, a["apic"]), nbytes, f"{live} live, pdata {tuple(pdata.shape)}")
        del b, pdata, counts
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
           nbytes, f"{live} live, {len(fields)} planes, buckets {r0}x{r1}x{k}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import subprocess
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
    consts = {n: getattr(tk, n, None) for n in ("P2G_BLOCKS_PER_SM", "P2G_MAX_BAND")}
    consts3 = {n: getattr(tk3, n) for n in ("P2G3D_BLOCKS_PER_SM", "P2G3D_MAX_BAND")}
    _build._loaded = full
    for tag, call, pcall, nbytes, what in states(dev):
        print(f"[{tag}] {what}; bytes in + out {nbytes}", flush=True)
        for tent in (False, True) if tag == "relfloor3d" else (False,):
            label = f"{tag}{' tent' if tent else ''}"
            _build._loaded = libs["committed"]
            want = call(tent)
            if not tent:
                buf = torch.empty_like(want)
                ms = cuda_ms(buf.zero_)
                print(f"[{label}] zero_() of the output ({buf.numel() * 4} bytes): {ms:.4f} ms, "
                      f"{buf.numel() * 4 / ms / 1e6:.0f} GB/s  [{card}]", flush=True)
                del buf
            if parent is not None:
                t = [cuda_ms(lambda: pcall(parent, tent)), cuda_ms(lambda: call(tent)),
                     cuda_ms(lambda: call(tent)), cuda_ms(lambda: pcall(parent, tent))]
                err = float((pcall(parent, tent) - want).abs().max())
                print(f"[{label}] parent {t[0]:.4f} / {t[3]:.4f} ms, committed {t[1]:.4f} / "
                      f"{t[2]:.4f} ms (CUDA events, 20 calls each, in turns); max |diff| "
                      f"parent vs committed {err:.3e}; committed at {nbytes / t[1] / 1e6:.0f} "
                      f"GB/s of bytes in + out  [{card}]", flush=True)
            for name, (_, over) in todo.items():
                _build._loaded = libs[name]
                for n, v in over.items():
                    setattr(tk3 if n.startswith("P2G3D") else tk, n, v)
                try:
                    got = call(tent)
                    same = torch.equal(got, call(tent))
                    err = float((got - want).abs().max())
                    ms = cuda_ms(lambda: call(tent))
                finally:
                    for n, v in {**consts, **consts3}.items():
                        setattr(tk3 if n.startswith("P2G3D") else tk, n, v)
                print(f"[{label}] {name}: {ms:.4f} ms (CUDA events, 20 calls), max |diff| "
                      f"against committed {err:.3e}, rerun bitwise equal {same}, "
                      f"{nbytes / ms / 1e6:.0f} GB/s  [{card}]", flush=True)
        _build._loaded = full   # the next state's run takes every kernel
        torch.cuda.empty_cache()
    _build._loaded = full
    return 0


if __name__ == "__main__":
    sys.exit(main())
