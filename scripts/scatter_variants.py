#!/usr/bin/env python3
"""Time the general path's fixed-order scatter (csrc/scatter.cu with its
plan in ops/cuda/scatter.py) against an earlier commit's and against other
designs, on one NVIDIA GPU.

    python3 scripts/scatter_variants.py [--parent DIR]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
DIR is an earlier checkout (`git archive` unpacked under build/): its
`csrc/scatter.cu` is built into its own library and its own wrapper and
plan (`ops/cuda/scatter.py`, loaded as a separate module: a stable sort
of the rows' node ids, M = N x 3^d keys) call it, bound with its own C
signatures.  The designs of this checkout, each built into its own
library under build/scatter_variants/ and swapped in behind the committed
wrapper through `_build._loaded`, all on the committed plan (one key a
particle):

- committed: a thread a node merging its runs, dense nodes by their warp;
- thread_only: the committed kernel without the warp walk (kHeavyRun out
  of reach): the plain thread-per-node merge;
- rows: 3D nodes in rows of 128 along the last axis instead of tiles;
- no_loads: a probe, wrong by design: the merge without the rows' loads;
- warp_rank: scripts/variants/scatter_warp_rank.cu, a warp a node, every
  row's rank found in parallel by binary searches, rows staged in shared
  memory at their ranks.

The plan is timed whole and its sort alone, beside a hand-written
counting sort of the same keys (scripts/variants/scatter_counting_sort.cu,
checked equal to the plan).  `index_add_` alone (into zeros) is the
library call; the parent's `p2g_scatter` also masked the clipped taps
with a `torch.where` over (N, S, c), timed on its own.  Cells, each the
momentum scatter of one general substep (the largest of its three):

- bench 1M: `bench.py:179-189` (1M particles, 513^2, float32), the
  initial state;
- slab 1M: `scenes.slab_3d()` (1M particles, 128^3, float32), initial;
- dense: bench 1M with 20,000 particles moved to one point (one key
  cell, 9 nodes each reading all of them).

At each cell the order is parent, committed, variants, committed, parent
(CUDA events, 10 calls each after 2, back to back; and on the device
alone, the calls queued behind a sleep kernel so that the host's time
between launches does not show); each line has the max |diff|
against the committed kernel, whether two reruns are bitwise equal to a
first, and the bytes bound (the rows read, the order, the starts and the
sums, each once, at 3.35 TB/s).  It also prints each build's registers
and spills (ptxas) and the card's name and power limit.
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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mpm_flip98a_tpu_torch import _build  # noqa: E402
from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind  # noqa: E402
from mpm_flip98a_tpu_torch.models import scenes, stabilized  # noqa: E402
from mpm_flip98a_tpu_torch.ops import transfer  # noqa: E402
from mpm_flip98a_tpu_torch.ops.cuda import scatter  # noqa: E402
from mpm_flip98a_tpu_torch.state import to_device  # noqa: E402

CSRC = ROOT / "mpm_flip98a_tpu_torch" / "csrc"
VARIANT_DIR = ROOT / "scripts" / "variants"
SRC = (CSRC / "scatter.cu").read_text()
OUT = ROOT / "build" / "scatter_variants"
ENTRIES = ("mpm_segment_sum_f32", "mpm_segment_sum_f64", "mpm_stencil_keys")
_P, _I = ctypes.c_void_p, ctypes.c_int
COUNTING = {"mpm_count_keys": (_P, _I, _P, _P), "mpm_place_keys": (_P, _I, _P, _P, _P, _P),
            "mpm_sort_runs": (_P, _P, _I, _P)}
PEAK_BYTES_PER_S = 3.35e12
BENCH = dict(dtype="float32", num_grids=513, dt=2e-6, num_particles_x=2000,
             num_particles_y=500, fluid_width=0.430, fluid_height=0.215, flip_blend=0.98,
             transfer=TransferKind.PIC)
SLAB_1M = dict(num_grids=128, particles_per_axis=(256, 256, 16))



def edit(src: str, old: str, new: str) -> str:
    assert old in src, old
    return src.replace(old, new)


LOAD = "        load_row(row, cw, vec, v);\n"
VARIANTS = {
    "committed": SRC,
    "thread_only": edit(SRC, "kHeavyRun = 64;", "kHeavyRun = 1 << 30;"),
    "rows": edit(edit(SRC, "  if (S != 27) {", "  if (true) {"), "  if (S == 27) blocks = ",
                 "  if (false) blocks = "),
    "no_loads": edit(SRC, LOAD, "        for (int ch = 0; ch < kCh; ++ch) v[ch] = T(0);\n"),
    "warp_rank": (VARIANT_DIR / "scatter_warp_rank.cu").read_text(),
}


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def build(name: str, src: str, signatures: dict) -> _build.Build:
    """`src` alone into one library bound with `signatures`."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / f"{name}.cu").write_text(src)
    log = _build._compile_and_link([d / f"{name}.cu"], d / "lib.so")
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn, argtypes in signatures.items():
        if not hasattr(lib, fn):      # a variant with the sum kernel alone
            continue
        getattr(lib, fn).argtypes = list(argtypes)
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


def device_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Device time a call: the calls queued behind a sleep kernel, so the
    host's time between launches does not show."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def counting_plan(lib, keys: torch.Tensor, cells: int) -> scatter.SegmentPlan:
    """The plan's order and starts by the hand-written counting sort."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    n = keys.numel()
    counts = torch.zeros(cells + 1, dtype=torch.int32, device=keys.device)
    assert lib.mpm_count_keys(ptr(keys), n, ptr(counts), stream) == 0
    starts = torch.zeros(cells + 2, dtype=torch.int32, device=keys.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=starts[1:])
    cursor = torch.zeros(cells + 1, dtype=torch.int32, device=keys.device)
    order = torch.empty(n, dtype=torch.int32, device=keys.device)
    assert lib.mpm_place_keys(ptr(keys), n, ptr(starts), ptr(cursor), ptr(order), stream) == 0
    assert lib.mpm_sort_runs(ptr(order), ptr(starts), cells + 1, stream) == 0
    return scatter.SegmentPlan(order, starts[: cells + 1])


def momentum_call(p, scene):
    """(values (N, S, c), base, offsets, grid shape) of the substep's
    largest stencil scatter."""
    seen, real = [], scatter.stencil_add

    def spy(values, base, offsets, grid_shape, plan=None):
        seen.append((values, base, offsets, tuple(grid_shape)))
        return real(values, base, offsets, grid_shape, plan)

    scatter.stencil_add = spy
    try:
        stabilized.substep(p, scene)
    finally:
        scatter.stencil_add = real
    return max(seen, key=lambda s: s[0].numel())


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
    full = _build.load()
    sigs = {k: _build.SIGNATURES[k] for k in ENTRIES}
    jobs = {name: (src, sigs) for name, src in VARIANTS.items()}
    jobs["counting"] = ((VARIANT_DIR / "scatter_counting_sort.cu").read_text(), COUNTING)
    parent = None
    if args.parent is not None:
        pkg = args.parent.resolve() / "mpm_flip98a_tpu_torch"
        parent_sigs = load_module("parent_build", pkg / "_build.py").SIGNATURES
        parent = load_module("parent_scatter", pkg / "ops" / "cuda" / "scatter.py")
        jobs["parent"] = ((pkg / "csrc" / "scatter.cu").read_text(),
                          {k: parent_sigs[k] for k in ENTRIES if k in parent_sigs})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, b in libs.items():
        regs = re.findall(r"Used (\d+) registers", b.log)
        spills = re.findall(r"(\d+) bytes spill stores", b.log)
        print(f"[ptxas] {name}: registers {regs}, spill stores {spills}", flush=True)

    dev = torch.device("cuda", 0)
    p_b, scene_b = scenes.dam_break_2d(MPMConfig(**BENCH), dtype=np.float32)
    p_s, scene_s = scenes.slab_3d(**SLAB_1M)
    x = p_b.x.clone()
    x[np.random.default_rng(0).choice(len(x), 20_000, replace=False)] = x[len(x) // 2].clone()
    p_d = dataclasses.replace(p_b, x=x)
    order = ["parent"] * bool(parent) + list(VARIANTS) + ["committed"] + ["parent"] * bool(parent)
    for tag, p, scene in (("bench 1M", p_b, scene_b), ("slab 1M", p_s, scene_s),
                          ("dense", p_d, scene_b)):
        _build._loaded = full
        state = to_device(p, dev)
        values, base, offsets, shape = momentum_call(state, scene)
        nodes, c = int(np.prod(shape)), values.shape[-1]
        index = transfer.flat_node_index(base, offsets, shape)
        plan = index.plan
        keys, cells = scatter.stencil_keys(base, shape)
        rows = values.reshape(-1, c)
        masked = torch.where(index.in_bounds[..., None], values, 0.0).reshape(-1, c)
        flat = index.flat.reshape(-1)
        calls = {"committed": lambda: scatter.stencil_add(values, base, offsets, shape, plan)}
        if parent is not None:
            pplan = parent.segment_plan(flat, nodes)
            calls["parent"] = lambda: parent.scatter_add(masked, flat, nodes, pplan)
        want = calls["committed"]()
        line = []
        for name in order:
            call = calls.get(name, calls["committed"])
            _build._loaded = libs[name]
            first = call()
            err = float((first - want).abs().max())
            rerun = all(torch.equal(first, call()) for _ in range(2))
            ms = cuda_ms(call)
            dev_ms = device_ms(call)
            line.append(f"{name} {ms:.4f} ({dev_ms:.4f})")
            print(f"[{tag}] {name}: {ms:.4f} ms (CUDA events, 10 calls; {dev_ms:.4f} ms on the "
                  f"device, queued behind a sleep), max |diff| against the "
                  f"committed kernel {err:.2e}, two reruns bitwise equal {rerun}  [{card}]",
                  flush=True)
            del first
        _build._loaded = full
        counted = counting_plan(libs["counting"].lib, keys, cells)
        same = torch.equal(counted.order, plan.order) and torch.equal(counted.starts, plan.starts)
        zero = torch.zeros((nodes, c), dtype=values.dtype, device=dev)
        sorted_keys = torch.sort(keys, stable=True).values
        t = {
            "plan": cuda_ms(lambda: scatter.stencil_plan(base, shape)),
            "sort": cuda_ms(lambda: torch.sort(keys, stable=True)),
            "keys": cuda_ms(lambda: scatter.stencil_keys(base, shape)),
            "starts": cuda_ms(lambda: torch.searchsorted(
                sorted_keys, torch.arange(cells + 1, dtype=torch.int32, device=dev),
                out_int32=True)),
            "counting": cuda_ms(lambda: counting_plan(libs["counting"].lib, keys, cells)),
            "index_add_": cuda_ms(lambda: zero.index_add_(0, flat, masked)),
            "mask": cuda_ms(lambda: torch.where(index.in_bounds[..., None], values, 0.0)),
        }
        t["plan_device"] = device_ms(lambda: scatter.stencil_plan(base, shape))
        t["index_add_device"] = device_ms(lambda: zero.index_add_(0, flat, masked))
        if parent is not None:
            t["parent_plan_device"] = device_ms(lambda: parent.segment_plan(flat, nodes))
            t["parent_plan"] = cuda_ms(lambda: parent.segment_plan(flat, nodes))
            t["parent_sort"] = cuda_ms(lambda: torch.sort(flat.to(torch.int32), stable=True))
        read = int(index.in_bounds.sum())
        n_kept = int(plan.starts[-1])
        nbytes = values.element_size() * (read + nodes) * c + 4 * (n_kept + cells + 1)
        runs = plan.starts[1:] - plan.starts[:-1]
        print(f"[{tag}] {values.shape[0]} particles x {values.shape[1]} taps x {c} channels "
              f"({values.dtype}) into {nodes} nodes; rows read {read}, longest run "
              f"{int(runs.max())}; plan (keys, stable sort, starts) "
              f"{t['plan']:.4f} ms (the keys {t['keys']:.4f}, the sort {t['sort']:.4f}, the "
              f"starts by searchsorted {t['starts']:.4f}; on the device {t['plan_device']:.4f}), "
              f"the counting sort "
              f"{t['counting']:.4f} ms (same plan {same}); index_add_ alone "
              f"{t['index_add_']:.4f} ms ({t['index_add_device']:.4f} on the device), the parent's "
              f"mask {t['mask']:.4f} ms"
              + (f", the parent's plan {t['parent_plan']:.4f} ms ({t['parent_plan_device']:.4f} "
                 f"on the device; its sort of {rows.shape[0]} "
                 f"int32 keys {t['parent_sort']:.4f} ms)" if parent is not None else "")
              + f"; bound {1e3 * nbytes / PEAK_BYTES_PER_S:.4f} ms (bytes)  [{card}]", flush=True)
        print(f"[{tag}] summary: " + ", ".join(line), flush=True)
        del state, values, base, index, plan, keys, rows, masked, flat, calls, want, zero, sorted_keys
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
