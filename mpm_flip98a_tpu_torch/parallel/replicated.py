"""Particle data parallelism with a replicated grid on a rank mesh (counterpart of `mpm_flip98a_tpu/parallel/replicated.py`).

The particles are split over the ranks of a `RankMesh` (parallel/mesh.py)
in contiguous slices; every rank runs the whole general substep against
its own copy of the full background grid, and the raw P2G sums are merged
by one `psum` (an `all_reduce`) before they are read.  The grid update and
G2P then run redundantly on every rank: grid work is O(G^dim), particle
work O(N).  This suits a small grid under many particles; a large grid
wants `parallel/domain.py`, which moves only O(halo) rows.
"""

from __future__ import annotations

import dataclasses

import torch

from mpm_flip98a_tpu_torch.models.stabilized import Scene, substep
from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh
from mpm_flip98a_tpu_torch.state import Particles, from_host_bits, host_bits


def pad_particles(p: Particles, multiple: int) -> Particles:
    """The particle set padded to a multiple of `multiple` with inert rows
    (replicated.py:26-63): zero mass and volume, so every scatter
    contribution vanishes, parked mid-domain at 0.5 * 0.4375 on every axis
    with F = I and J = density = Jp = 1."""
    rem = (-p.n) % multiple
    if rem == 0:
        return p
    d, dt, dev = p.dim, p.x.dtype, p.x.device

    def pad(a, fill=0.0):
        return torch.cat([a, torch.full((rem,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                        device=dev)])

    eye = torch.eye(d, dtype=dt, device=dev).expand(rem, d, d)
    return Particles(
        x=pad(p.x, 0.5 * 0.4375),
        v=pad(p.v),
        C=pad(p.C),
        F=torch.cat([p.F, eye]),
        J=pad(p.J, 1.0),
        stress=pad(p.stress),
        material=pad(p.material, 0),
        volume0=pad(p.volume0),
        mass=pad(p.mass),
        density=pad(p.density, 1.0),
        pressure=pad(p.pressure),
        div_v=pad(p.div_v),
        pou=pad(p.pou),
        consistency=pad(p.consistency),
        Jp=pad(p.Jp, 1.0),
    )


def shard_particles(p: Particles, mesh: RankMesh) -> Particles:
    """This rank's contiguous slice of a (padded) particle set, on the
    mesh's device."""
    if p.n % mesh.n:
        raise ValueError(f"{p.n} particles do not split over {mesh.n} ranks: pad them first")
    k = p.n // mesh.n
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name)[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)
        for f in dataclasses.fields(p)})


def make_run(scene: Scene, mesh: RankMesh):
    """`run(p, n_substeps)`: this rank's slice stepped with the grid merged
    over the ranks (replicated.py:72-90)."""
    reduce = lambda g: mesh.psum(g)

    def run(p: Particles, n_substeps: int) -> Particles:
        for _ in range(n_substeps):
            p = substep(p, scene, grid_reduce=reduce)
        return p

    return run


def collect(p: Particles, mesh: RankMesh) -> Particles:
    """Every rank's slice, in rank order, on the host (on every rank)."""
    return dataclasses.replace(p, **{
        f.name: mesh.all_gather(getattr(p, f.name)).flatten(0, 1).cpu()
        for f in dataclasses.fields(p)})


def run_jobs(mesh: RankMesh, jobs) -> list:
    """A `launch.run_ranks` worker: for each job (scene, n_substeps,
    fields), `fields` the padded host particles as numpy arrays (every
    rank gets them all; bfloat16 as `state.host_bits` records), every
    rank's slice after `make_run`'s n_substeps (`collect`), as such
    arrays."""
    out = []
    for scene, n_substeps, fields in jobs:
        p = Particles(**{f.name: from_host_bits(fields[f.name])
                         for f in dataclasses.fields(Particles)})
        q = collect(make_run(scene, mesh)(shard_particles(p, mesh), n_substeps), mesh)
        out.append({f.name: host_bits(getattr(q, f.name)) for f in dataclasses.fields(q)})
    return out
