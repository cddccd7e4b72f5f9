"""The rank worker of tests/test_torch_fast_ranks.py and the scenes both sides build.

`run_jobs(mesh, jobs)` runs on every rank of one `launch.run_ranks`
launch (4 gloo ranks on the CPU); each job is a dict whose `kind` picks
what the rank does, and the rank returns host data only.  The scenes are
functions here so that the parent builds the same particles for its
references (the port's `SlabMesh` runs, JAX's `shard_map` runs).  This
module imports no JAX: the ranks start from a fresh import.
"""

import dataclasses

import numpy as np
import torch

from mpm_flip98a_tpu_torch import driver
from mpm_flip98a_tpu_torch.config import MPMConfig, TransferKind
from mpm_flip98a_tpu_torch.models import fast2d, scenes
from mpm_flip98a_tpu_torch.parallel import fast_domain as fd
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3
from mpm_flip98a_tpu_torch.parallel import fast_replicated as fr
from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh

N = 4
# tests/test_parallel_fast_domain.py:24-32 and tests/test_parallel_fast.py:12-14.
FAST_KW = dict(dtype="float32", num_grids=37, dt=2e-5, num_particles_x=16, num_particles_y=32)
SMALL = dict(num_grids=16, particles_per_axis=(6, 6, 10), dtype=np.float32)


def scene2d(name):
    """(particles, scene) of a 2D case.

    - "migrate": the FLIP dam column moved to the middle of shard 1 (rows
      [10, 20) of 37) and split in two, its halves 2.5 cells either side
      of the middle, the left one thrown at -30 m/s and the right one at
      +30 m/s, so that slots cross both slab edges within 100 substeps;
    - "ext": the incompressible projection and CSF surface tension;
    - "replicated": tests/test_parallel_fast.py's APIC dam break;
    - "prepped": the stabilized switch set (F-bar, pressure mixing, the
      penalty walls; tests/test_torch_fast_domain.py's SWITCHES), which
      takes `p2g`'s prepped branch."""
    if name == "replicated":
        return scenes.dam_break_2d(MPMConfig(**FAST_KW), dtype=np.float32)
    if name == "prepped":
        return scenes.dam_break_2d(MPMConfig(
            **FAST_KW, flip_blend=0.98, transfer=TransferKind.PIC, use_fbar=True,
            pressure_mixing_ratio=0.5, use_penalty_ebc=True), dtype=np.float32)
    if name == "ext":
        return scenes.dam_break_2d(MPMConfig(
            **FAST_KW, flip_blend=0.98, transfer=TransferKind.PIC, incompressible=True,
            surface_tension=1.0), dtype=np.float32)
    p, scene = scenes.dam_break_2d(MPMConfig(**FAST_KW, flip_blend=0.98,
                                             transfer=TransferKind.PIC), dtype=np.float32)
    x, v = p.x.clone(), p.v.clone()
    mid, dx = float(x[:, 0].mean()), float(scene.cfg.dx)
    side = torch.where(x[:, 0] < mid, -1.0, 1.0)
    v[:, 0] = 30.0 * side
    x[:, 0] += 14.0 * dx - mid + 2.5 * dx * side
    return dataclasses.replace(p, x=x, v=v), scene


def scene3d():
    """SMALL's 3D dam column 3 cells up both bucketed axes and thrown
    diagonally at 12 m/s, dt 2e-4: its slots cross the window edges of
    the 4-slab and the 2 x 2 mesh within 20 substeps."""
    p, scene = scenes.dam_break_3d(**SMALL, dt=2e-4)
    x, v = p.x.clone(), torch.zeros_like(p.v)
    for a in (0, 1):
        x[:, a] += 3.0 * float(scene.cfg.dx)
        v[:, a] = 12.0
    return dataclasses.replace(p, x=x, v=v), scene


def spec2d(p, scene):
    return fd.FastDomainSpec.for_particles(scene.cfg, N, p, headroom=2.0)


def spec3d(p, scene, grid):
    return fd3.FastDomain3DSpec.for_particles(scene.cfg, grid or N, p, headroom=2.0)


def host(b) -> dict:
    return {f.name: getattr(b, f.name).cpu().numpy() for f in dataclasses.fields(b)}


def _zero_axis1(mesh: RankMesh) -> RankMesh:
    """A planted fault: every axis-1 leg (halo and migration) delivers
    zeros."""
    real = mesh._shift
    mesh._shift = lambda x, down, rows, tag, axis: (
        torch.zeros_like(x) if axis == 1 else real(x, down, rows, tag, axis))
    return mesh


def run_job(mesh: RankMesh, job: dict) -> dict:
    kind = job["kind"]
    if kind == "shifts":
        m2 = RankMesh(mesh.device, mesh.backend, grid=(2, 2))
        x = torch.from_numpy(job["blocks"][m2.rank])
        return {f"{op} {axis}": getattr(m2, op)(x, axis=axis).numpy()
                for op in ("shift_left", "shift_right") for axis in (0, 1)}
    if kind == "2d":
        p, scene = scene2d(job["scene"])
        spec = spec2d(p, scene)
        b = fd.distribute(p, scene.cfg, spec, mesh)
        out, stats, run = {"start": host(fd.collect(b, mesh))}, fast2d.RunStats(), \
            fd.make_run(scene, spec, mesh)
        done = 0
        for n_sub in job["snapshots"]:
            b = run(b, n_sub - done, stats)
            done = n_sub
            out[n_sub] = host(fd.collect(b, mesh))
        out["rebuckets"] = stats.rebuckets
        return out
    if kind == "3d":
        grid = job["grid"]
        p, scene = scene3d()
        m = mesh if grid is None else RankMesh(mesh.device, mesh.backend, grid=grid)
        if job.get("fault"):
            m = _zero_axis1(m)
        spec = spec3d(p, scene, grid)
        b = fd3.distribute(p, scene.cfg, spec, m)
        start = host(fd.collect(b, m))
        stats = fast2d.RunStats()
        b = fd3.make_run(scene, spec, m)(b, job["n"], stats)
        return {"start": start, "end": host(fd.collect(b, m)), "rebuckets": stats.rebuckets}
    if kind == "checkpoint":
        # Resume a SlabMesh shard directory on the ranks; write the ranks'
        # own directory after the same first leg.
        p, scene = scene2d("migrate")
        sim = lambda: driver.Simulation(p, scene, path="fast", devices=N, mesh=mesh,
                                        out_dir=job["out"])
        a = sim()
        a.step_frame(job["first"])
        a.save_checkpoint(job["ranks_dir"])
        a.save_checkpoint(job["ranks_dir"] + ".npz")
        out = {}
        for kind, path in (("dir", job["slab_dir"]), ("npz", job["slab_dir"] + ".npz")):
            b = sim()
            b.restore_checkpoint(path)
            b.step_frame(job["second"])
            out[kind] = host(b.global_state())
            out[kind + "_frame_count"] = b.frame_count
        return out
    if kind == "replicated":
        p, scene = scene2d(job["scene"])
        b, spec = fr.distribute(p, scene.cfg, mesh)
        start = host(fr.collect(b, mesh))
        mesh.traffic.clear()
        b = fr.make_run(scene, spec, mesh)(b, job["n"])
        psum = mesh.traffic["grid_psum"]
        return {"start": start, "end": host(fr.collect(b, mesh)),
                "positions": fr.collect_positions(b, mesh), "psum_calls": psum.calls,
                "psum_bytes": psum.bytes}
    raise ValueError(f"unknown job kind {kind!r}")


def run_jobs(mesh: RankMesh, jobs) -> list:
    """`launch.run_ranks`' worker: each job's result on this rank."""
    return [run_job(mesh, job) for job in jobs]
