#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout.  It imports nothing of JAX.  Phases:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA;
2. build    the transfer kernels, compiled by nvcc from
            mpm_flip98a_tpu_torch/csrc for sm_90a;
3. kernels  each kernel against its plain PyTorch version on the main
            path's inputs at the bench scale (1M particles, 513^2 grid,
            dt = 2e-6: bench.py:179-189) after 20 substeps, plus P2G's
            partition of unity there and on a ragged synthetic case;
4. main     the CLI on dam2d_flip98 (2 frames x 200 substeps), then the
            same Simulation at the bench scale (2 frames x 100 substeps):
            launch counters, finite state, no overflow, constant mass,
            every particle in the box;
5. timing   ms per substep and transfer ops/s (n * 9 * 2 * substeps /
            seconds) for the kernel path and the plain path, median of 3
            repeats of 100 substeps; each kernel against its plain version
            by CUDA events.

Any failed check raises and the script exits non-zero.  Without a CUDA
device it exits with code 2 before doing anything.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel-against-plain bound, per output channel, scaled by the channel's
# max: both sides sum each node's ~40 fp32 terms in another order (shared
# atomics in the P2G kernel, global atomics in the plain index_add_, FMA
# contraction in the G2P kernel).
KERNEL_REL_TOL = 1e-5
POU_REL_TOL = 1e-6           # P2G mass channel vs total particle mass
BENCH = dict(                # bench.py:179-189, the 1M / 513^2 dam break
    dtype="float32", num_grids=513, dt=2e-6, num_particles_x=2000,
    num_particles_y=500, fluid_width=0.430, fluid_height=0.215,
    flip_blend=0.98,
)
TPU_KERNELS = {
    "p2g_fused": ("mpm_flip98a_tpu_torch/csrc/p2g_fused.cu",
                  "mpm_flip98a_tpu/ops/pallas/transfer2d.py:412"),
    "g2p": ("mpm_flip98a_tpu_torch/csrc/g2p.cu",
            "mpm_flip98a_tpu/ops/pallas/transfer2d.py:843"),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def scaled_errors(got, want, axis, scale=None):
    """Per-channel (max abs err, that err / scale), scale defaulting to the
    channel's max |want|."""
    g = got.movedim(axis, 0).reshape(got.shape[axis], -1).double()
    w = want.movedim(axis, 0).reshape(want.shape[axis], -1).double()
    err = (g - w).abs().amax(dim=1)
    if scale is None:
        scale = w.abs().amax(dim=1)
    scale = torch.as_tensor(scale, dtype=torch.float64, device=err.device)
    return err.tolist(), (err / scale.clamp(min=1e-30)).tolist()


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


def compare_kernels(tag, sdata, pdata2, counts, grid4, args, dinv, card):
    """Kernel vs plain for both transfers on one set of inputs; returns the
    worst absolute errors.  Plain calls here do not touch the counters."""
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    got = tk.p2g_fused(sdata, counts, **args)
    want = tk.p2g_fused_plain(sdata, counts, **args)
    err_p, rel_p = scaled_errors(got, want, axis=2)
    # Partition of unity: every slot in these inputs has all 9 taps inside.
    live = torch.arange(sdata.shape[2], device=sdata.device)[None, :] < counts[:, None]
    m_total = (sdata[:, 9].double() * live).sum().item()
    m_grid = got[:, :, 4].double().sum().item()
    pou = abs(m_grid - m_total) / m_total
    say(f"[kernels:{tag}] p2g_fused max_abs_err per channel {err_p} "
        f"scaled {['%.2e' % r for r in rel_p]} (tol {KERNEL_REL_TOL})  "
        f"mass sum rel err {pou:.3e} (tol {POU_REL_TOL})  [{card}]")
    check(max(rel_p) <= KERNEL_REL_TOL, f"{tag}: p2g_fused disagrees with its plain version")
    check(pou <= POU_REL_TOL, f"{tag}: p2g_fused partition of unity")

    got = tk.g2p(pdata2, counts, grid4, args["dx"], dinv)
    want = tk.g2p_plain(pdata2, counts, grid4, args["dx"], dinv)
    # C sums +-(x_node - x_p) terms that cancel where the velocity field is
    # smooth, so its channels are scaled by one term's size, D^-1 dx |v|max.
    vmax = grid4[:, :2].abs().amax(dim=(0, 2)).double()
    c_unit = dinv * args["dx"] * vmax
    scale = torch.cat([want[:, :4].abs().amax(dim=(0, 2)).double(), c_unit.repeat_interleave(2)])
    err_g, rel_g = scaled_errors(got, want, axis=1, scale=scale)
    say(f"[kernels:{tag}] g2p max_abs_err per channel {err_g} "
        f"scaled {['%.2e' % r for r in rel_g]} (tol {KERNEL_REL_TOL})  [{card}]")
    check(max(rel_g) <= KERNEL_REL_TOL, f"{tag}: g2p disagrees with its plain version")
    return max(err_p), max(err_g)


def ragged_inputs(device, seed=0):
    """Partly filled and empty buckets, particles on both column edges; all
    taps inside the grid so the mass must be conserved exactly."""
    rng = np.random.default_rng(seed)
    r, k, g = 64, 1024, 513
    counts = rng.integers(0, k + 1, r)
    counts[::7] = 0
    counts[3] = k
    rel = rng.integers(-1, 2, (r, k))
    gx0 = np.arange(r)[:, None] + rel + 0.5 + rng.random((r, k)) * 0.999
    edge = rng.random((r, k))
    gx1 = np.where(edge < 0.2, 0.5 + rng.random((r, k)) * 0.01,        # left edge
          np.where(edge < 0.4, g - 2.0 + rng.random((r, k)) * 0.49,    # right edge
                   rng.uniform(0.5, g - 1.51, (r, k))))
    live = np.arange(k)[None, :] < counts[:, None]
    v = rng.normal(0.0, 1.0, (2, r, k))
    c = rng.normal(0.0, 50.0, (4, r, k))
    j = np.where(live, rng.uniform(0.98, 1.02, (r, k)), 1.0)
    mass = np.where(live, rng.uniform(1e-4, 2e-4, (r, k)), 0.0)
    vol0 = mass / 997.5
    sdata = np.stack([gx0, gx1, *v, *c, j, mass, vol0], axis=1).astype(np.float32)
    pdata2 = np.stack([gx0, gx1, live], axis=1).astype(np.float32)
    grid4 = rng.normal(0.0, 1.0, (r, 4, g)).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device).contiguous()
    return t(sdata), t(pdata2), t(counts, torch.int32), t(grid4), g


def host_checks(tag, sim, n0, p0_mass, card):
    """Finite, no overflow, constant mass, every particle inside the box."""
    from mpm_flip98a_tpu_torch.models import fast2d

    h = fast2d.to_host(sim.state)
    x = np.stack([h["x0"], h["x1"]], -1)
    cfg = sim.cfg
    finite = all(np.isfinite(h[n]).all() for n in ("x0", "x1", "v0", "v1", "J"))
    overflow = int(sim.state.overflow)
    mass = float(h["mass"].astype(np.float64).sum())
    inside = bool(((x > -cfg.dx) & (x < cfg.domain_length + cfg.dx)).all())
    say(f"[main:{tag}] particles {x.shape[0]} finite {finite} overflow {overflow} "
        f"mass {mass!r} (initial {p0_mass!r}) inside box {inside} "
        f"rebuckets {sim.stats.rebuckets} host reads {sim.stats.host_reads}  [{card}]")
    check(finite, f"{tag}: non-finite state")
    check(overflow == 0, f"{tag}: bucket overflow")
    check(x.shape[0] == n0, f"{tag}: {x.shape[0]} particles, expected {n0}")
    check(abs(mass - p0_mass) <= 1e-9 * p0_mass, f"{tag}: mass changed")
    check(inside, f"{tag}: particle outside the box")


def frame_io_available() -> bool:
    from mpm_flip98a_tpu_torch.utils import native_io

    if native_io.available():
        return True
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def time_run(b, scene, spec, n_sub, plain):
    """Seconds for `run` of n_sub substeps (host clock around work that
    ends in a synchronise)."""
    from mpm_flip98a_tpu_torch.models import fast2d

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast2d.run(b, scene, spec, n_sub, plain=plain)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def time_substeps_no_check(b, scene, n_sub, reps):
    """The same substeps without the per-substep margin read (state is
    discarded): the difference to `time_path` is the host read's cost."""
    from mpm_flip98a_tpu_torch.models import fast2d

    times = []
    for _ in range(reps):
        s = b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_sub):
            s = fast2d.substep(s, scene)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler table of 20 bench substeps here")
    args = ap.parse_args(argv)

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from mpm_flip98a_tpu_torch import _build, driver
    from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
    from mpm_flip98a_tpu_torch.models import fast2d, scenes
    from mpm_flip98a_tpu_torch.ops.cuda import transfer2d as tk

    check("jax" not in sys.modules, "jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    say(f"[device] {card}")
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)} capability {torch.cuda.get_device_capability(0)}")

    # ---- 2. build ---------------------------------------------------------
    build = _build.load()
    say(f"[build] {'cached' if build.cached else 'nvcc'} {build.seconds:.2f} s -> "
        f"{os.path.relpath(build.path, root)} from "
        f"{[os.path.relpath(s, root) for s in _build.sources()]} "
        f"flags {' '.join(_build.NVCC_FLAGS)}")
    for line in build.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "smem" in line:
            say(f"[build] {line.strip()}")

    # ---- 3. kernels against plain ----------------------------------------
    cfg = MPMConfig(**BENCH, transfer=TransferKind.PIC)
    t0 = time.perf_counter()
    p_big, scene_big = scenes.dam_break_2d(cfg, dtype=np.float32)
    spec_big = fast2d.FastSpec.for_particles(cfg, p_big)
    b = fast2d.from_particles(p_big, cfg, spec_big, dev)
    b = fast2d.run(b, scene_big, spec_big, 20)
    torch.cuda.synchronize()
    say(f"[kernels] bench state: {p_big.n} particles, grid {cfg.num_grids}^2, "
        f"buckets {tuple(b.shape)}, 20 substeps in {time.perf_counter() - t0:.2f} s")
    sdata, pdata2, counts = fast2d.transfer_inputs(b, cfg)
    p_args = fast2d.p2g_args(scene_big)
    dinv = float(4.0 * cfg.inv_dx * cfg.inv_dx)
    grid_bench = fast2d._grid_update2d(
        tk.fold_rows(tk.p2g_fused(sdata, counts, **p_args)), scene_big
    )
    err_p2g, err_g2p = compare_kernels(
        "bench", sdata, pdata2, counts, grid_bench, p_args, dinv, card
    )
    rs, rp, rc, rgrid, rg = ragged_inputs(dev)
    compare_kernels("ragged", rs, rp, rc, rgrid, {**p_args, "g": rg}, dinv, card)
    kernel_ms = {
        "p2g_fused": cuda_ms(lambda: tk.p2g_fused(sdata, counts, **p_args)),
        "g2p": cuda_ms(lambda: tk.g2p(pdata2, counts, grid_bench, p_args["dx"], dinv)),
    }
    plain_ms = {
        "p2g_fused": cuda_ms(lambda: tk.p2g_fused_plain(sdata, counts, **p_args)),
        "g2p": cuda_ms(lambda: tk.g2p_plain(pdata2, counts, grid_bench, p_args["dx"], dinv)),
    }
    for name in TPU_KERNELS:
        say(f"[kernels] {name} at bench shapes: kernel {kernel_ms[name]:.4f} ms, "
            f"plain {plain_ms[name]:.4f} ms (CUDA events, 20 calls)  [{card}]")

    # ---- 4. main path -----------------------------------------------------
    io_ok = frame_io_available()
    if not io_ok:
        say("[main] frame IO unavailable (no native writer, no PIL): "
            "running with frame output off")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        n_frames, n_sub = 2, 200
        argv_cli = [
            "--scenario", "dam2d_flip98", "--path", "fast", "--frames", str(n_frames),
            "--substeps", str(n_sub), "--no-gif", "--out", out_dir, "--device", "cuda",
        ]
        p_ref, _ = driver.SCENARIOS["dam2d_flip98"]()
        mass_ref = float(p_ref.mass.to(torch.float32).double().sum())
        tk.reset_launches()
        if io_ok:
            sim = driver.main(argv_cli)
        else:
            p, scene = driver.SCENARIOS["dam2d_flip98"]()
            sim = driver.Simulation(p, scene, out_dir=out_dir, device=dev)
            sim.run(n_frames, n_sub, gif=False, write_frames=False)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        say(f"[main:dam2d_flip98] {'CLI ' + ' '.join(argv_cli) if io_ok else 'Simulation'}: "
            f"launches {launches}, substeps {sim.stats.substeps}")
        for name in TPU_KERNELS:
            check(launches[name] == n_frames * n_sub == sim.stats.substeps,
                  f"{name} launched {launches[name]} times for {n_frames * n_sub} substeps")
        host_checks("dam2d_flip98", sim, p_ref.n, mass_ref, card)
        if io_ok:
            frames = sorted(os.listdir(sim.frame_dir)), sorted(os.listdir(sim.vtk_dir))
            say(f"[main:dam2d_flip98] frames {frames}")
            check(len(frames[0]) == len(frames[1]) == n_frames, "frame files missing")

        mass_big = float(p_big.mass.to(torch.float32).double().sum())
        sim_big = driver.Simulation(p_big, scene_big, out_dir=out_dir, device=dev)
        tk.reset_launches()
        t0 = time.perf_counter()
        sim_big.run(2, 100, gif=False, verbose=False, write_frames=io_ok)
        torch.cuda.synchronize()
        launches_big = dict(tk.LAUNCHES)
        say(f"[main:bench] Simulation 2 frames x 100 substeps in "
            f"{time.perf_counter() - t0:.2f} s, launches {launches_big}, "
            f"capacity {sim_big.spec.capacity}")
        say("[main:bench] timers\n" + sim_big.timers.summary())
        for name in TPU_KERNELS:
            check(launches_big[name] == 200, f"bench: {name} launched {launches_big[name]} times")
        host_checks("bench", sim_big, p_big.n, mass_big, card)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 5. timing at the bench scale -------------------------------------
    b = sim_big.state
    spec = sim_big.spec
    n_sub, reps = 100, 3
    ops = p_big.n * cfg.stencil_size * 2 * n_sub
    runs = {False: [], True: []}
    for plain in (False, True):    # warm-up
        time_run(b, scene_big, spec, 10, plain)
    for _ in range(reps):          # interleaved: kernel, plain, kernel, plain ...
        for plain in (False, True):
            runs[plain].append(time_run(b, scene_big, spec, n_sub, plain))
    no_check = time_substeps_no_check(b, scene_big, n_sub, reps)
    for label, ts in (("kernel path", runs[False]), ("plain path", runs[True]),
                      ("kernel path, no margin read", no_check)):
        med = float(np.median(ts))
        say(f"[timing] {label}: {1e3 * med / n_sub:.4f} ms/substep "
            f"(median of {reps} x {n_sub}; runs {[round(1e3 * t / n_sub, 4) for t in ts]} "
            f"ms/substep), {ops / med:.4e} transfer ops/s  [{card}]")
    read_ms = 1e3 * (np.median(runs[False]) - np.median(no_check)) / n_sub
    say(f"[timing] per-substep margin read costs {read_ms:.4f} ms/substep  [{card}]")

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        from torch.profiler import ProfilerActivity, profile

        fast2d.run(b, scene_big, spec, 5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fast2d.run(b, scene_big, spec, 20)
            torch.cuda.synchronize()
        events = prof.key_averages()
        table = events.table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(args.profile, "profile_bench_20_substeps.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        # Device busy time: the kernels' own time (device-side events only).
        busy_ms = sum(
            getattr(e, "self_device_time_total", 0.0) for e in events
            if str(e.device_type).endswith("CUDA")
        ) / 1e3 / 20
        wall_ms = 1e3 * float(np.median(runs[False])) / n_sub
        say(f"[timing] profile written to {args.profile}: device busy "
            f"{busy_ms:.4f} ms/substep against {wall_ms:.4f} ms/substep unprofiled "
            f"(idle share {1.0 - busy_ms / wall_ms:.3f})  [{card}]")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name],
         "max_abs_err": {"p2g_fused": err_p2g, "g2p": err_g2p}[name],
         "ms": kernel_ms[name], "plain_ms": plain_ms[name]}
        for name, (src, tpu) in TPU_KERNELS.items()
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
