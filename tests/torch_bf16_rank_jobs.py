"""The rank worker of tests/test_torch_bf16_ranks*.py and the bfloat16 scenes both sides build.

`run_jobs(mesh, jobs)` runs on every rank of one `launch.run_ranks`
launch (gloo ranks on the CPU); each job is a dict whose `kind` picks
what the rank does, and the rank returns host data only, bfloat16 as
`state.host_bits` records.  The fast-path scenes are functions here so
that the ranks and the parent build the same particles.  This module
imports no JAX: the ranks start from a fresh import.
"""

import dataclasses
import os

import torch

import torch_fast_rank_jobs as fast_jobs
from mpm_flip98a_tpu_torch import driver
from mpm_flip98a_tpu_torch.parallel import domain, launch, replicated
from mpm_flip98a_tpu_torch.parallel import fast_domain as fd
from mpm_flip98a_tpu_torch.parallel import fast_domain3d as fd3
from mpm_flip98a_tpu_torch.parallel import fast_replicated as fr
from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh
from mpm_flip98a_tpu_torch.state import Particles, from_host_bits, host_bits
from mpm_flip98a_tpu_torch.utils import io_vtk


def to_bf16(p):
    """p with every float32 field cast to bfloat16 (tests/test_dtypes.py:30-37)."""
    return dataclasses.replace(p, **{f.name: getattr(p, f.name).bfloat16()
                                     for f in dataclasses.fields(p)
                                     if getattr(p, f.name).dtype == torch.float32})


def cast32(p):
    """p with every bfloat16 field widened to float32 (exactly)."""
    return dataclasses.replace(p, **{f.name: getattr(p, f.name).float()
                                     for f in dataclasses.fields(p)
                                     if getattr(p, f.name).dtype == torch.bfloat16})


def fast_scene(name):
    """(bfloat16 particles, scene) of a fast-path case: the float32 scenes
    of tests/torch_fast_rank_jobs.py ("migrate", "replicated"; "3d" its
    thrown 3D column) cast to bfloat16."""
    p, scene = fast_jobs.scene3d() if name == "3d" else fast_jobs.scene2d(name)
    return to_bf16(p), scene


def host(b) -> dict:
    return {f.name: host_bits(getattr(b, f.name)) for f in dataclasses.fields(b)}


def _fast(mesh: RankMesh, job: dict, p) -> dict:
    """One fast rank form from particles p: its spec, the collected start
    and the collected state after job["n"] substeps."""
    kind, n = job["kind"], job["n"]
    _, scene = fast_scene("3d" if kind == "fast3d" else job.get("scene", "migrate"))
    if kind == "fast2d":
        spec = fast_jobs.spec2d(p, scene)
        b = fd.distribute(p, scene.cfg, spec, mesh)
        start = host(fd.collect(b, mesh))
        b = fd.make_run(scene, spec, mesh)(b, n)
        return {"spec": dataclasses.asdict(spec), "start": start, "end": host(fd.collect(b, mesh))}
    if kind == "fast3d":
        grid = job["grid"]
        m = mesh if grid is None else RankMesh(mesh.device, mesh.backend, grid=grid)
        spec = fast_jobs.spec3d(p, scene, grid)
        b = fd3.distribute(p, scene.cfg, spec, m)
        start = host(fd.collect(b, m))
        b = fd3.make_run(scene, spec, m)(b, n)
        return {"spec": dataclasses.asdict(spec), "start": start, "end": host(fd.collect(b, m))}
    b, spec = fr.distribute(p, scene.cfg, mesh)
    start = host(fr.collect(b, mesh))
    b = fr.make_run(scene, spec, mesh)(b, n)
    return {"spec": dataclasses.asdict(spec), "start": start, "end": host(fr.collect(b, mesh))}


def _simulation(mesh: RankMesh, job: dict, p) -> dict:
    """`Simulation(mesh=RankMesh)` on the fast path from particles p: a
    frame written, a per-rank checkpoint, a fresh Simulation resumed from
    it for a second frame; the global state after each, the frame's
    positions as rank 0 wrote them."""
    _, scene = fast_scene("migrate")
    out_dir = os.path.join(job["out"], job["tag"])
    sim = lambda: driver.Simulation(p, scene, path="fast", devices=mesh.n, mesh=mesh,
                                    out_dir=out_dir)
    a = sim()
    a.run(1, job["n"], gif=False, verbose=False)
    ck = os.path.join(job["out"], job["tag"] + "_ck")
    a.save_checkpoint(ck)
    first = host(a.global_state())
    positions = a.positions()
    vtk = (io_vtk.read_vtk_points(os.path.join(a.vtk_dir, "00001.vtk")) if a.lead else None)
    b = sim()
    b.restore_checkpoint(ck)
    b.step_frame(job["n"])
    return {"first": first, "resumed": host(b.global_state()), "frame_count": b.frame_count,
            "positions": positions, "vtk": vtk}


def run_job(mesh: RankMesh, job: dict):
    kind = job["kind"]
    if kind == "domain":
        return domain.run_jobs(mesh, [(job["scene"], job["spec"], job["n"], job["start"])])[0]
    if kind == "collect":
        # distribute, make_run and collect themselves: every rank gets the
        # active particles of all.
        p = Particles(**{name: from_host_bits(a) for name, a in job["start"].items()})
        state, _ = domain.distribute(p, job["scene"], job["spec"], mesh)
        state = domain.make_run(job["scene"], job["spec"], mesh)(state, job["n"])
        return host(domain.collect(state, mesh))
    if kind == "replicated":
        return replicated.run_jobs(mesh, [(job["scene"], job["n"], job["fields"])])[0]
    if kind == "psum":
        # Through `launch.mesh_calls`, which carries bf16 as 16-bit records.
        names = list(job["blocks"])
        got = launch.mesh_calls(mesh, [(["psum"] * mesh.n, job["blocks"][name], [{}] * mesh.n)
                                       for name in names])
        return dict(zip(names, got))
    if kind == "halo":
        # domain.halo_reduce on this rank's (L + 2H, k) bf16 buffer.
        buf = from_host_bits(job["blocks"][mesh.rank])
        return host_bits(domain.halo_reduce(buf, mesh, job["L"]))
    if kind in ("fast2d", "fast3d", "fast_replicated", "simulation"):
        p16, _ = fast_scene("3d" if kind == "fast3d" else job.get("scene", "migrate"))
        go = _simulation if kind == "simulation" else _fast
        return {"bf16": go(mesh, job, p16), "float32": go(mesh, {**job, "tag": job.get(
            "tag", kind) + "_32"}, cast32(p16))}
    raise ValueError(f"unknown job kind {kind!r}")


def run_jobs(mesh: RankMesh, jobs) -> list:
    """`launch.run_ranks`' worker: each job's result on this rank."""
    return [run_job(mesh, job) for job in jobs]
