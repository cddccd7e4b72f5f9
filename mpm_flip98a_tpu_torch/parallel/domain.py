"""Slab domain decomposition of the general path on a rank mesh (counterpart of `mpm_flip98a_tpu/parallel/domain.py`).

The background grid is cut along axis 0 into slabs of L rows, one slab per
rank of a `RankMesh` (parallel/mesh.py; `parallel/launch.run_ranks` starts
the ranks).  Each rank keeps its slab plus H = 2 halo rows on both sides,
the quadratic B-spline's reach:

    local rows [0, H) | interior [H, L+H) | [L+H, L+2H)
    = global  [sL-H, sL) |  [sL, (s+1)L)  | [(s+1)L, (s+1)L+H)

and runs the whole general substep (`models/stabilized.substep`) on it, as
a chip runs its shard inside the JAX package's `shard_map`.  Every raw P2G
sum is completed by `make_halo_sync`: the edge strips that belong to a
neighbour's interior are sent and added there (`halo_reduce`), then the
completed interior edge strips are copied back into the neighbours' halos
(`halo_gather`); the ranks at the domain's ends receive zeros.  The CSF
chain and the projection refresh their halos with `halo_gather` and take
their maxima and dot products over the ranks (`GridContext.mesh`).

Particles live per rank in fixed-capacity buffers with inert padding
(mass = volume0 = 0).  After each substep the particles whose stencil
base row left the slab migrate to the adjacent rank (`migrate`): packed by
a stable argsort, at most `mig_cap` a direction, placed into the inert
slots in order; what does not fit is counted in `DomainState.dropped`,
which must stay 0.  A migration exchange sends the count and then only
the valid rows (not the full `mig_cap` buffer, whose other rows are
invalid): the receiver places the same rows in the same slots.

`distribute` and `collect` are host-side, as in the JAX module; every rank
computes the same layout and keeps its own shard.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpm_flip98a_tpu_torch.config import MPMConfig
from mpm_flip98a_tpu_torch.models import colliders as _col
from mpm_flip98a_tpu_torch.models.stabilized import (
    PAD, GridContext, Scene, _grid_coords, substep,
)
from mpm_flip98a_tpu_torch.parallel.mesh import RankMesh
from mpm_flip98a_tpu_torch.state import Particles, from_host_bits, host_array, host_bits

H = 2  # halo width in grid rows = the stencil's reach (config.py:41-43)

_FIELDS = [f.name for f in dataclasses.fields(Particles)]


@dataclasses.dataclass(frozen=True)
class DomainState:
    """This rank's shard: `capacity` particle slots and its (1,) int32
    count of particles lost to overflow (the rank's entry of the JAX
    state's (n,) `dropped`)."""

    particles: Particles
    dropped: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """Static decomposition parameters (domain.py:71-112)."""

    n_shards: int
    rows_per_shard: int   # L: slab height in grid rows
    capacity: int         # particle slots per shard
    mig_cap: int          # migration slots per direction per substep

    @staticmethod
    def for_scene(cfg: MPMConfig, n_shards: int, n_particles: int,
                  headroom: float = 2.0) -> "DomainSpec":
        rows = -(-cfg.num_grids // n_shards)
        cap = max(64, int(headroom * -(-n_particles // n_shards)))
        cap = -(-cap // 64) * 64
        return DomainSpec(n_shards, rows, cap, max(16, cap // 4))

    @staticmethod
    def for_particles(cfg: MPMConfig, n_shards: int, p: Particles,
                      headroom: float = 2.0) -> "DomainSpec":
        """Capacity from the initial slab occupancy: free-surface scenes
        are skewed (the dam column fills only the left slabs)."""
        rows = -(-cfg.num_grids // n_shards)
        shard = _owning_shard(host_array(p.x), cfg, rows, n_shards)
        occupancy = int(np.bincount(shard, minlength=n_shards).max())
        cap = max(64, int(headroom * occupancy))
        cap = -(-cap // 64) * 64
        return DomainSpec(n_shards, rows, cap, max(16, cap // 4))


def _owning_shard(x: np.ndarray, cfg: MPMConfig, rows: int, n: int) -> np.ndarray:
    """Host-side owning shard of each particle (numpy, as domain.py:98-100
    and :289-291 compute it).  bfloat16 positions come widened to float32
    (`state.host_array`): the reference's bfloat16 arrays promote to
    float32 as they meet a Python float, so this row is taken in float32
    arithmetic, where `_base_row` takes bfloat16's."""
    row = np.floor(x[:, 0] * cfg.inv_dx + PAD - 0.5).astype(np.int64)
    return np.clip(row // rows, 0, n - 1)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def halo_reduce(buf: torch.Tensor, mesh: RankMesh, L: int) -> torch.Tensor:
    """Add the edge strips' partial sums into the owning neighbour's
    interior, in place (domain.py:128-134)."""
    from_right = mesh.shift_left(buf[:H], tag="halo")
    buf[L:L + H] += from_right
    from_left = mesh.shift_right(buf[L + H:L + 2 * H], tag="halo")
    buf[H:2 * H] += from_left
    return buf


def halo_gather(buf: torch.Tensor, mesh: RankMesh, L: int) -> torch.Tensor:
    """Copy the neighbours' completed interior strips into the halos, in
    place (domain.py:137-143)."""
    buf[L + H:L + 2 * H] = mesh.shift_left(buf[H:2 * H], tag="halo")
    buf[:H] = mesh.shift_right(buf[L:L + H], tag="halo")
    return buf


def make_halo_sync(mesh: RankMesh, L: int):
    def sync(buf: torch.Tensor) -> torch.Tensor:
        return halo_gather(halo_reduce(buf, mesh, L), mesh, L)

    return sync


# ---------------------------------------------------------------------------
# Particle migration
# ---------------------------------------------------------------------------


def _base_row(p: Particles, cfg: MPMConfig) -> torch.Tensor:
    """Global stencil base row in the state's dtype: x inv_dx + PAD, then
    floor(. - 0.5), the order of domain.py:170-173 (another order moves a
    particle on a slab line to another shard in float32).  In bfloat16
    each operation rounds to bfloat16, inv_dx first (`config.Bf16`), as
    the reference computes it on the device."""
    return torch.floor(_grid_coords(p.x[:, 0], cfg) - 0.5).to(torch.int64)


def _deactivate(p: Particles, mask: torch.Tensor, slab_center: torch.Tensor) -> Particles:
    """Departed rows made inert: no weight, parked at the slab centre with
    F = I and J = Jp = density = 1 (domain.py:176-201)."""
    d = p.dim
    m, md, mm = mask, mask[:, None], mask[:, None, None]
    eye = torch.eye(d, dtype=p.x.dtype, device=p.x.device)
    return Particles(
        x=torch.where(md, slab_center, p.x),
        v=torch.where(md, 0.0, p.v),
        C=torch.where(mm, 0.0, p.C),
        F=torch.where(mm, eye, p.F),
        J=torch.where(m, 1.0, p.J),
        stress=torch.where(mm, 0.0, p.stress),
        material=torch.where(m, 0, p.material),
        volume0=torch.where(m, 0.0, p.volume0),
        mass=torch.where(m, 0.0, p.mass),
        density=torch.where(m, 1.0, p.density),
        pressure=torch.where(m, 0.0, p.pressure),
        div_v=torch.where(m, 0.0, p.div_v),
        pou=torch.where(m, 0.0, p.pou),
        consistency=torch.where(md, 0.0, p.consistency),
        Jp=torch.where(m, 1.0, p.Jp),
    )


def _rows_bytes(p: Particles, idx: torch.Tensor) -> torch.Tensor:
    """(k, B) uint8: every field's bytes of the rows `idx`, side by side."""
    cols = []
    for n in _FIELDS:
        a = getattr(p, n)
        width = int(np.prod(a.shape[1:], dtype=np.int64))
        cols.append(a[idx].reshape(len(idx), width).contiguous().view(torch.uint8))
    return torch.cat(cols, dim=1)


def _rows_from_bytes(raw: torch.Tensor, like: Particles) -> dict:
    """The fields of `_rows_bytes`' rows, in `like`'s dtypes and shapes."""
    out, at = {}, 0
    for n in _FIELDS:
        a = getattr(like, n)
        width = int(np.prod(a.shape[1:], dtype=np.int64)) * a.element_size()
        # A copy: a one-row slice is contiguous but keeps its byte offset,
        # which a wider dtype's view needs aligned (bfloat16 fields leave
        # the next field's offset at 2 bytes).
        out[n] = raw[:, at:at + width].clone().view(a.dtype).reshape(
            (raw.shape[0],) + tuple(a.shape[1:]))
        at += width
    return out


def migrate(p: Particles, dropped: torch.Tensor, scene: Scene, spec: DomainSpec,
            mesh: RankMesh) -> Tuple[Particles, torch.Tensor]:
    """Move the particles whose base row left this rank's slab to the
    neighbouring rank (domain.py:204-270); returns the new shard and
    `dropped` plus what did not fit.  The host reads the counts of movers,
    of arrivals and of free slots, which size the exchange; a substep
    without movers or arrivals leaves the shard as it is."""
    cfg = scene.cfg
    L, M = spec.rows_per_shard, spec.mig_cap
    lo = mesh.rank * L

    active = p.mass > 0
    row = _base_row(p, cfg)
    go_left = active & (row < lo)
    go_right = active & (row >= lo + L)
    # True rows first, in slot order (stable); at most M a direction, the
    # rest dropped (counted).
    order_l = torch.argsort((~go_left).to(torch.uint8), stable=True)
    order_r = torch.argsort((~go_right).to(torch.uint8), stable=True)
    count = torch.stack([go_left.sum(), go_right.sum()])
    overflow = (count - M).clamp(min=0).sum()
    k_send = count.clamp(max=M)
    # Arrival counts first (every rank learns how many rows it receives),
    # then the rows themselves: my left-goers to the left neighbour, my
    # right-goers to the right.
    n_from_right = int(mesh.shift_left(k_send[:1], tag="migrate"))
    n_from_left = int(mesh.shift_right(k_send[1:], tag="migrate"))
    k_l, k_r = (int(k) for k in k_send.cpu())
    in_right = mesh.shift_left(_rows_bytes(p, order_l[:k_l]), rows=n_from_right, tag="migrate")
    in_left = mesh.shift_right(_rows_bytes(p, order_r[:k_r]), rows=n_from_left, tag="migrate")
    if k_l or k_r:
        # Deactivate every departing row locally.  The centre is rounded
        # from float64 to the state's dtype as jnp.asarray rounds it
        # (through float32 for bfloat16, as torch casts).
        slab_center = torch.full((p.dim,), 0.5 * cfg.domain_length, dtype=p.x.dtype,
                                 device=p.x.device)
        slab_center[0] = (lo + L // 2 - PAD) * cfg.dx
        p = _deactivate(p, go_left | go_right, slab_center)
        active = p.mass > 0

    # Arrivals go into the free slots in order (a stable argsort puts the
    # inert slots first): the left neighbour's first, then the right's
    # after the left's actual count.
    lost = 0
    if n_from_left or n_from_right:
        free = torch.argsort(active.to(torch.uint8), stable=True)
        num_free = int((~active).sum())
        fields = {n: getattr(p, n).clone() for n in _FIELDS}
        for raw, start in ((in_left, 0), (in_right, n_from_left)):
            fit = max(0, min(raw.shape[0], num_free - start))
            lost += raw.shape[0] - fit
            if fit:
                slots = free[start:start + fit]
                for n, rows in _rows_from_bytes(raw[:fit], p).items():
                    fields[n][slots] = rows
        p = Particles(**fields)
    return p, dropped + (overflow + lost).to(torch.int32)


# ---------------------------------------------------------------------------
# Distribution and the sharded runner
# ---------------------------------------------------------------------------


def layout(p: Particles, scene: Scene, spec: DomainSpec) -> Tuple[dict, np.ndarray]:
    """Host-side: the particles bucketed by owning slab, each bucket padded
    to capacity with inert rows, as numpy arrays of (n capacity, ...) in
    shard order (domain.py:278-336; bfloat16 fields as `state.host_bits`
    records); and perm, perm[i] = the slot of input particle i.  The
    padding is made in float64 and cast to each field's dtype as the
    reference's `astype` casts it (float64 to bfloat16 through float32,
    as torch casts)."""
    cfg = scene.cfg
    n, L, C = spec.n_shards, spec.rows_per_shard, spec.capacity
    host = {name: getattr(p, name).detach().cpu() for name in _FIELDS}
    shard = _owning_shard(host_array(p.x), cfg, L, n)
    d = p.dim
    fill = dict(v=0.0, C=0.0, J=1.0, stress=0.0, material=0, volume0=0.0, mass=0.0,
                density=1.0, pressure=0.0, div_v=0.0, pou=0.0, consistency=0.0, Jp=1.0)

    perm = np.zeros(p.n, np.int64)
    chunks = {name: [] for name in _FIELDS}
    for s in range(n):
        idx = np.nonzero(shard == s)[0]
        if len(idx) > C:
            raise ValueError(f"shard {s} needs {len(idx)} slots but capacity is {C}")
        perm[idx] = s * C + np.arange(len(idx))
        pad = C - len(idx)
        center = np.full((pad, d), 0.5 * cfg.domain_length)
        center[:, 0] = (s * L + L // 2 - PAD) * cfg.dx
        blocks = dict(x=center, F=np.broadcast_to(np.eye(d), (pad, d, d)))
        for name in _FIELDS:
            a = host[name]
            blk = blocks.get(name)
            if blk is None:
                blk = np.broadcast_to(fill[name], (pad,) + tuple(a.shape[1:]))
            blk = torch.from_numpy(np.ascontiguousarray(blk)).to(a.dtype)
            chunks[name].append(torch.cat([a[torch.from_numpy(idx)], blk]))
    return {name: host_bits(torch.cat(c)) for name, c in chunks.items()}, perm


def distribute(p: Particles, scene: Scene, spec: DomainSpec,
               mesh: RankMesh) -> Tuple[DomainState, np.ndarray]:
    """This rank's shard of `layout` on the mesh's device, with `dropped`
    0; and perm, the same on every rank."""
    if mesh.n != spec.n_shards:
        raise ValueError(f"spec has {spec.n_shards} shards, mesh {mesh.n} ranks")
    full, perm = layout(p, scene, spec)
    C = spec.capacity
    mine = slice(mesh.rank * C, (mesh.rank + 1) * C)
    particles = Particles(**{name: from_host_bits(a[mine], mesh.device)
                             for name, a in full.items()})
    dropped = torch.zeros((1,), dtype=torch.int32, device=mesh.device)
    return DomainState(particles, dropped), perm


def context(scene: Scene, spec: DomainSpec, mesh: RankMesh) -> GridContext:
    """This rank's slab buffers and hooks (domain.py:360-375)."""
    cfg = scene.cfg
    d, L, s = cfg.dim, spec.rows_per_shard, mesh.rank
    dev = mesh.device
    rows = torch.arange(L + 2 * H, device=dev)
    shift = torch.zeros((d,), dtype=torch.int64, device=dev)
    shift[0] = s * L - H
    return GridContext(
        node_shape=(L + 2 * H,) + (cfg.num_grids,) * (d - 1),
        cell_shape=(L + 2 * H,) + (cfg.num_cells,) * (d - 1),
        base_shift=shift,
        row_index0=s * L - H + rows,
        mesh=mesh,
        halo_exchange=lambda buf: halo_gather(buf, mesh, L),
        own_rows=(rows >= H) & (rows < L + H),
    )


def make_run(scene: Scene, spec: DomainSpec, mesh: RankMesh):
    """`run(state, n_substeps, t0=None)`: this rank's substeps, each the
    general substep on the slab with the halo sync as its reduce, then the
    migration (domain.py:346-399).  `t0` (simulation seconds) moves
    kinematic colliders; every rank's substep i sees the same t."""
    if mesh.n != spec.n_shards:
        raise ValueError(f"spec has {spec.n_shards} shards, mesh {mesh.n} ranks")
    ctx = context(scene, spec, mesh)
    sync = make_halo_sync(mesh, spec.rows_per_shard)
    moving = _col.any_moving(scene.colliders)

    def run(state: DomainState, n_substeps: int, t0=None) -> DomainState:
        for i in range(n_substeps):
            # The reference's t: float32(t0) + i dt.
            t = float(np.float32(t0)) + i * scene.cfg.dt if moving and t0 is not None else None
            p = substep(state.particles, scene, ctx, t, grid_reduce=sync)
            state = DomainState(*migrate(p, state.dropped, scene, spec, mesh))
        return state

    return run


def collect(state: DomainState, mesh: RankMesh) -> Particles:
    """The active particles of every rank, on the host of every rank, in
    shard-then-slot order (domain.py:402-407)."""
    full = {name: mesh.all_gather(getattr(state.particles, name)).flatten(0, 1).cpu()
            for name in _FIELDS}
    active = full["mass"] > 0
    return Particles(**{name: a[active] for name, a in full.items()})


def run_jobs(mesh: RankMesh, jobs) -> list:
    """A `launch.run_ranks` worker: for each job (scene, spec, n_substeps,
    start), this rank's shard after `make_run`'s n_substeps, as numpy
    arrays (`state.host_bits`: bfloat16 as records of its bits) with its
    `dropped`.
    `start` is the host particles as a dict of such arrays (every rank
    gets them all and `distribute`s), or a state in the global layout,
    ({field: (n capacity, ...)}, dropped (n,)), taken as it is."""
    from mpm_flip98a_tpu_torch import convert

    out = []
    for scene, spec, n_substeps, start in jobs:
        if isinstance(start, tuple):
            state = convert.domain_state_from_numpy(*start, mesh.rank, mesh.n, mesh.device)
        else:
            p = Particles(**{name: from_host_bits(start[name]) for name in _FIELDS})
            state, _ = distribute(p, scene, spec, mesh)
        state = make_run(scene, spec, mesh)(state, n_substeps)
        out.append({name: host_bits(getattr(state.particles, name)) for name in _FIELDS})
        out[-1]["dropped"] = state.dropped.cpu().numpy()
    return out
