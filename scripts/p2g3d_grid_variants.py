#!/usr/bin/env python3
"""Time the port's 3D P2G + grid-update kernel against an earlier commit's
and against variants of it, on one NVIDIA GPU.

    python3 scripts/p2g3d_grid_variants.py [--parent DIR]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
DIR is an earlier checkout (`git archive` unpacked under build/): its
`csrc/` is built into its own library and its own wrapper and planner
(`ops/cuda/transfer3d.py`, loaded as a separate module) call it, bound
with its own C signatures.  The committed kernel and its variants (text
edits of `csrc/p2g3d_grid.cu`, each built into its own library under
build/p2g3d_grid_variants/) are swapped in behind the committed wrapper
through `_build._loaded`.  Each is timed with CUDA events (10 calls) at
three states:

- slab 8M: BASELINE.json configs[3] (8.4M particles, 256^3) after 20
  substeps, stress mode, 7 channels, PIC;
- stab3d-8M: the same slab with F-bar, penalty walls and pressure mixing
  after 5 substeps, prepped mode, 11 channels, PIC;
- drop3d: elastic_drop_3d at 128^3 (3.5M particles) after 20 substeps,
  prepped mode, 7 channels, APIC.

Variants of the committed kernel:
- half_cap: chunks of half the committed plan's records (1073 at 7
  channels PIC, 841-894 at 96-byte records, 720 at 112);
- probes of where its time goes, whose outputs are wrong by design:
  no_sums drops the sums (every walk, sort and record store stays),
  no_records also the records' loads and stores (the walks and the sort
  stay), walk0_only returns after walk 0 and the zero columns.

At each state the order is parent, committed, variants, committed,
parent; each line has the max |diff| against the committed kernel's
output and whether two reruns are bitwise equal to a first.  It also
prints each build's registers and spills (ptxas) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mpm_flip98a_tpu_torch import _build, driver  # noqa: E402
from mpm_flip98a_tpu_torch.models import fast3d, scenes  # noqa: E402
from mpm_flip98a_tpu_torch.ops.cuda import transfer3d as tk3  # noqa: E402

CSRC = ROOT / "mpm_flip98a_tpu_torch" / "csrc"
SRC = (CSRC / "p2g3d_grid.cu").read_text()
OUT = ROOT / "build" / "p2g3d_grid_variants"
ENTRIES = ("mpm_p2g3d_grid", "mpm_p2g3d_grid_pdata")
VISIT = """            rec3d::visit<kNch, kTent, kApic, -2, kNT - 1>(stage + static_cast<size_t>(q) * R::kVec,
                                                          jz, dx, acc);
"""
RECORD = SRC[SRC.index("            const int v = s0 + (st << 5) + lane;\n"):
             SRC.index("rec3d::put_rec<R::kVec>(rec, stage")]
RECORD += ("rec3d::put_rec<R::kVec>(rec, stage + static_cast<size_t>(pos[r]) * R::kVec);\n"
           "            }\n")
WALK0 = "  if (!any) return;\n"


def half_cap(nch, g2, r0, r1, shards=1, apic=True, plan=tk3.plan_p2g3d_grid):
    """The committed plan with half its chunk: the records' shared memory
    halved."""
    full = plan(nch, g2, r0, r1, shards, apic)
    cap = full.cap // 2
    return dataclasses.replace(full, cap=cap, smem=full.smem - (full.cap - cap) * full.rec)


def without(src: str, *parts: str) -> str:
    for part in parts:
        assert part in src, part
        src = src.replace(part, "", 1)
    return src


# name -> (p2g3d_grid.cu, planner overrides of transfer3d's module constants)
VARIANTS = {
    "committed": (SRC, {}),
    "half_cap": (SRC, {"plan_p2g3d_grid": half_cap}),
    "rows2": (SRC.replace("constexpr int kRows = 1;", "constexpr int kRows = 2;"),
              {"GRID3D_ROWS": 2, "GRID3D_COLS": 32}),
    "no_sums": (without(SRC, VISIT), {}),
    "no_records": (without(SRC, VISIT, RECORD), {}),
    "walk0_only": (SRC.replace(WALK0, "  return;\n"), {}),
}


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module     # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def build(name: str, csrc: Path, src: str, signatures: dict) -> _build.Build:
    """p2g3d_grid.cu (as `src`) and the headers of `csrc`, into one library
    bound with `signatures` for ENTRIES."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d / "csrc")
    (d / "csrc" / "p2g3d_grid.cu").write_text(src)
    log = _build._compile_and_link([d / "csrc" / "p2g3d_grid.cu",
                                    *sorted((d / "csrc").glob("*.cuh"))], d / "lib.so")
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn in ENTRIES:
        getattr(lib, fn).argtypes = list(signatures[fn])
        getattr(lib, fn).restype = ctypes.c_int
    return _build.Build(lib, d / "lib.so", 0.0, False, log)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an earlier checkout to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    full = _build.load()     # every kernel, for the runs that make the states
    jobs = {name: (CSRC, src, _build.SIGNATURES) for name, (src, _) in VARIANTS.items()}
    parent_tk3 = None
    if args.parent is not None:
        pkg = args.parent.resolve() / "mpm_flip98a_tpu_torch"
        parent_sigs = load_module("parent_build", pkg / "_build.py").SIGNATURES
        parent_tk3 = load_module("parent_transfer3d", pkg / "ops" / "cuda" / "transfer3d.py")
        jobs["parent"] = (pkg / "csrc", (pkg / "csrc" / "p2g3d_grid.cu").read_text(),
                          parent_sigs)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, b in libs.items():
        regs = re.findall(r"Used (\d+) registers", b.log)
        spills = re.findall(r"(\d+) bytes spill stores", b.log)
        print(f"[ptxas] {name}: registers {regs}, spill stores {spills}", flush=True)

    dev = torch.device("cuda", 0)
    p8, slab = scenes.slab_3d(num_grids=256, particles_per_axis=(512, 512, 32))
    stab = dataclasses.replace(slab, cfg=dataclasses.replace(
        slab.cfg, use_fbar=True, use_penalty_ebc=True, pressure_mixing_ratio=1.0))
    p_d, drop = scenes.elastic_drop_3d(num_grids=128, fluid_particles=(230, 230, 64),
                                       block_particles=(51, 51, 51), dt=1e-5)
    order = ["parent"] * bool(parent_tk3) + list(VARIANTS) + ["committed"] + \
        ["parent"] * bool(parent_tk3)
    for tag, p, scene, n_sub in (("slab 8M", p8, slab, 20), ("stab3d-8M", p8, stab, 5),
                                 ("drop3d", p_d, drop, 20)):
        _build._loaded = full
        sim = driver.Simulation(p, scene, out_dir=str(OUT), device=dev, path="fast")
        sim.run(1, n_sub, gif=False, verbose=False, write_frames=False)
        b, spec = sim.state, sim.spec
        kw = fast3d.p2g_args(scene)
        if fast3d.uses_fused(scene):
            fields, counts, _, _ = fast3d.transfer_inputs(b, spec, scene.cfg)
        else:
            fields, counts = fast3d.prepped_fields(b, scene, spec), fast3d.pencil_counts(b)
        calls = {"committed": lambda: tk3.p2g3d_grid(fields, counts, spec.rows1, **kw)}
        if parent_tk3 is not None:
            calls["parent"] = lambda: parent_tk3.p2g3d_grid(fields, counts, spec.rows1, **kw)
        _build._loaded = libs["committed"]
        want = calls["committed"]()
        for name in order:
            call = calls.get(name, calls["committed"])
            keep = {k: getattr(tk3, k) for k in VARIANTS.get(name, (None, {}))[1]}
            _build._loaded = libs[name]
            try:
                for k, v in VARIANTS.get(name, (None, {}))[1].items():
                    setattr(tk3, k, v)
                first = call()
                err = float((first - want).abs().max())
                rerun = all(torch.equal(first, call()) for _ in range(2))
                ms = cuda_ms(call)
            finally:
                for k, v in keep.items():
                    setattr(tk3, k, v)
            print(f"[{tag}] {name}: {ms:.4f} ms (CUDA events, 10 calls), max |diff| against the "
                  f"committed kernel {err:.2e}, two reruns bitwise equal {rerun}  [{card}]",
                  flush=True)
            del first
        del sim, b, fields, counts, want, calls
        torch.cuda.empty_cache()
    _build._loaded = full
    return 0


if __name__ == "__main__":
    sys.exit(main())
