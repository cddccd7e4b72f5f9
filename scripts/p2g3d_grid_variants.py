#!/usr/bin/env python3
"""Time variants of the port's 3D P2G + grid-update kernel on one NVIDIA GPU.

    python3 scripts/p2g3d_grid_variants.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds `mpm_flip98a_tpu_torch/csrc/p2g3d_grid.cu` as committed and
variants of it (text edits of the source, each built into its own library
under build/p2g3d_grid_variants/), swaps each library in behind the
wrapper `ops/cuda/transfer3d.p2g3d_grid`, and times one call with CUDA
events at three states:

- slab 8M: BASELINE.json configs[3] (8.4M particles, 256^3) after 20
  substeps, stress mode, 7 channels, PIC;
- stab3d-8M: the same slab with F-bar, penalty walls and pressure mixing
  after 5 substeps, prepped mode, 11 channels, PIC;
- drop3d: elastic_drop_3d at 128^3 (3.5M particles) after 20 substeps,
  prepped mode, 7 channels, APIC.

Variants:
- committed: the source as it is (kBlocksPerSM = 4);
- blocks2, blocks3, blocks5: kBlocksPerSM set to 2, 3 or 5, with the
  planner's shared-memory budget to match;
- apic_blocks2: the APIC kernels at 2 blocks per SM (the register cap of
  128), the PIC ones at 4, the committed plan;
- apic_blocks2_band: the same with a 4 x 8 tile and a 2-block slab (a
  wider z band);
- cas_batch: every channel's compare-and-swap issued before any result is
  read (atomicCAS in place of atomicAdd);
- racy_rmw: a plain read-modify-write in place of the atomics.  Its sums
  are wrong; it is a probe of what the atomics cost.

It also prints, for the committed build, the shared-memory atomic opcodes
in the kernels' SASS (cuobjdump), each variant's registers and spills
(ptxas), and the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
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

SRC = (ROOT / "mpm_flip98a_tpu_torch" / "csrc" / "p2g3d_grid.cu").read_text()
OUT = ROOT / "build" / "p2g3d_grid_variants"
BLOCKS = "constexpr int kBlocksPerSM = 4;"
BOUNDS = "__launch_bounds__(kThreads, kBlocksPerSM)"
ADD = "taps::add_tap<kNch, kApic>(slot, pure, forced, j2, w01 * slot.wz[j2],"
CAS_BATCH = '''template <int kNch, bool kApic>
__device__ __forceinline__ void cas_add(const taps::Slot<kNch>& s, const float pure[3],
                                        const float forced[3], int j2, float w, float* at,
                                        int cs) {
  float v[kNch];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = kApic ? w * (pure[a] + s.p[3 * a + 2] * s.cdz[j2]) : w * pure[a];
    v[3 + a] = w * (forced[a] + s.q[3 * a + 2] * s.cdz[j2]);
  }
#pragma unroll
  for (int e = 0; e < taps::Slot<kNch>::kPlain; ++e) v[6 + e] = w * s.plain[e];
  unsigned old[kNch], got[kNch];
  bool done[kNch];
#pragma unroll
  for (int ch = 0; ch < kNch; ++ch) {
    old[ch] = *reinterpret_cast<volatile unsigned*>(at + ch * cs);
    done[ch] = false;
  }
  while (true) {
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      if (!done[ch]) {
        got[ch] = atomicCAS(reinterpret_cast<unsigned*>(at + ch * cs), old[ch],
                            __float_as_uint(__uint_as_float(old[ch]) + v[ch]));
      }
    }
    bool all = true;
#pragma unroll
    for (int ch = 0; ch < kNch; ++ch) {
      if (!done[ch]) {
        done[ch] = got[ch] == old[ch];
        old[ch] = got[ch];
        all = all && done[ch];
      }
    }
    if (all) break;
  }
}
'''
RACY = '''template <int kNch, bool kApic>
__device__ __forceinline__ void racy_add(const taps::Slot<kNch>& s, const float pure[3],
                                         const float forced[3], int j2, float w, float* at,
                                         int cs) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    at[a * cs] += kApic ? w * (pure[a] + s.p[3 * a + 2] * s.cdz[j2]) : w * pure[a];
    at[(3 + a) * cs] += w * (forced[a] + s.q[3 * a + 2] * s.cdz[j2]);
  }
#pragma unroll
  for (int e = 0; e < taps::Slot<kNch>::kPlain; ++e) at[(6 + e) * cs] += w * s.plain[e];
}
'''
HELPERS_AT = "// A slot's stencil rows against the tile:"
SMEM_RESERVED = 1_024 + tk3.SMEM_STATIC


def with_add(helper: str, name: str) -> str:
    src = SRC.replace(HELPERS_AT, helper + "\n" + HELPERS_AT)
    return src.replace(ADD, f"{name}<kNch, kApic>(slot, pure, forced, j2, w01 * slot.wz[j2],")


def budget(blocks: int) -> int:
    return tk3.SMEM_SM // blocks - SMEM_RESERVED


# name -> (source, planner tiles or None, slab budget in bytes)
VARIANTS = {
    "committed": (SRC, None, budget(4)),
    "blocks2": (SRC.replace(BLOCKS, "constexpr int kBlocksPerSM = 2;"), None, budget(2)),
    "blocks3": (SRC.replace(BLOCKS, "constexpr int kBlocksPerSM = 3;"), None, budget(3)),
    "blocks5": (SRC.replace(BLOCKS, "constexpr int kBlocksPerSM = 5;"), None, budget(5)),
    "apic_blocks2": (SRC.replace(BOUNDS, "__launch_bounds__(kThreads, kApic ? 2 : kBlocksPerSM)"),
                     None, budget(4)),
    "apic_blocks2_band": (SRC.replace(BOUNDS,
                                      "__launch_bounds__(kThreads, kApic ? 2 : kBlocksPerSM)"),
                          ((4, 8),), budget(2)),
    "cas_batch": (with_add(CAS_BATCH, "cas_add"), None, budget(4)),
    "racy_rmw": (with_add(RACY, "racy_add"), None, budget(4)),
}


def build(name: str, src: str):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "mpm_flip98a_tpu_torch" / "csrc", d / "csrc")
    (d / "csrc" / "p2g3d_grid.cu").write_text(src)
    log = _build._compile_and_link([d / "csrc" / "p2g3d_grid.cu", d / "csrc" / "taps.cuh"],
                                   d / "lib.so")
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn in ("mpm_p2g3d_grid", "mpm_p2g3d_grid_pdata"):
        getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int
    return _build.Build(lib, d / "lib.so", 0.0, False, log)


def sass_atomics(path: Path) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = collections.Counter(), None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\b(ATOMS\.[A-Z0-9.]+|ATOMS)\b", line)
        if m and fn and "p2g3d_grid_kernel" in fn:
            counts[m.group(1)] += 1
    return dict(counts)


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
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    full = _build.load()     # every kernel, for the runs that make the states
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kv: build(kv[0], kv[1][0]), VARIANTS.items())))
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[sass] committed p2g3d_grid kernels' shared atomics: "
          f"{sass_atomics(libs['committed'].path)}", flush=True)
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
    plan, tiles = tk3.plan_p2g3d_grid, tk3.TILES
    for tag, p, scene, n_sub in (("slab 8M", p8, slab, 20), ("stab3d-8M", p8, stab, 5),
                                 ("drop3d", p_d, drop, 20)):
        _build._loaded = full
        sim = driver.Simulation(p, scene, out_dir=str(OUT), device=dev)
        sim.run(1, n_sub, gif=False, verbose=False, write_frames=False)
        b, spec = sim.state, sim.spec
        args = fast3d.p2g_args(scene)
        if fast3d.uses_fused(scene):
            fields, counts, _, _ = fast3d.transfer_inputs(b, spec, scene.cfg)
        else:
            fields, counts = fast3d.prepped_fields(b, scene, spec), fast3d.pencil_counts(b)
        call = lambda: tk3.p2g3d_grid(fields, counts, spec.rows1, **args)
        nch = tk3.P2G_CH_EXT if args.get("ext") else tk3.P2G_CH
        want = call()
        for name, (_, tile_list, smem) in VARIANTS.items():
            _build._loaded = libs[name]
            tk3.TILES = tile_list or tiles
            tk3.SMEM_BLOCK, keep = smem, tk3.SMEM_BLOCK
            try:
                err = float((call() - want).abs().max())
                ms = cuda_ms(call)
                pl = plan(nch, args["g2"], spec.rows0, spec.rows1)
            finally:
                tk3.TILES, tk3.SMEM_BLOCK = tiles, keep
            print(f"[{tag}] {name}: {ms:.4f} ms (CUDA events, 10 calls), max |diff| against "
                  f"the committed kernel {err:.2e}, tile {pl.t0}x{pl.t1}, band {pl.band}, "
                  f"{pl.smem} shared bytes  [{card}]", flush=True)
        del sim, b, fields, counts, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
